"""Accuracy-configurability sweep: the paper's central knob.

Counterpart of ``examples/accuracy_sweep.py``, with ``--device``.  For
each splitting point t of an 8-bit multiplier, reports circuit-level error
metrics (paper Fig. 2), the analytic latency win (paper Fig. 3), AND the
end-task effect: the eval loss of a small trained LM with its MLPs
quantized through the approximate multiplier at that t (``bitexact``: the
``lut_matmul`` kernel on the card).

  PYTHONPATH=src python -m repro_torch.examples.accuracy_sweep --steps 80 [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import apply_approx, get_config
from repro_torch.core import error_metrics
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.engine.config import ripple_delay, segmented_delay
from repro_torch.models.registry import build_model
from repro_torch.train.steps import init_train_state, loss_fn, make_train_step

N = 8


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ---- train a small exact model once
    cfg = get_config("qwen3-0.6b").reduced(vocab_size=256)
    model = build_model(cfg)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=10, total_steps=args.steps)
    state = init_train_state(model, tcfg, 0, device=device)
    step = make_train_step(model, tcfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8))

    def batch(i: int) -> dict:
        return {k: torch.as_tensor(v, device=device) for k, v in data.batch(i).items()}

    for i in range(args.steps):
        state, m = step(state, batch(i))
    print(f"trained exact model: loss={float(m['loss']):.4f}\n")

    # ---- evaluate through the approximate multiplier at each t
    eval_batch = batch(10_000)
    print(f"{'t':>2} {'ER':>7} {'NMED':>10} {'latency_win%':>13} {'eval_loss':>10}")
    for t in [None, 1, 2, 3, 4, 5, 6, 7]:
        if t is None:
            acfg, er, nmed, win = cfg, 0.0, 0.0, 0.0
        else:
            acfg = apply_approx(cfg, n=N, t=t, mode="bitexact")
            rep = error_metrics.exhaustive_eval(N, t, device=device)
            er, nmed = rep.er, rep.nmed
            win = 100 * (1 - segmented_delay(N, t) / ripple_delay(N))
        with torch.no_grad():
            loss, _ = loss_fn(state.params, eval_batch, 1, build_model(acfg))
        label = "exact" if t is None else str(t)
        print(f"{label:>2} {er:7.3f} {nmed:10.2e} {win:13.1f} {float(loss):10.4f}")


if __name__ == "__main__":
    main()
