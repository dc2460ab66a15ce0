"""End-to-end training driver on one device.

Counterpart of ``repro/launch/train.py``, with the same flags and summary
lines, plus ``--device``: it runs on ``cuda`` unless ``--device cpu`` is
given, and without a GPU and without that flag it raises.  Weights and
data are made from ``--seed``.

  # paper technique on, bit-exact approximate MLPs, full width on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-multiplier \
      --steps 100 --batch 8 --seq 128

  # the reduced configuration on the CPU (the plain versions of the kernels)
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-multiplier \
      --reduced --device cpu --steps 16 --batch 2 --seq 32

Every ``--arch`` of ``configs.registry`` trains: qwen2-vl-7b on text
tokens (t = h = w), the MoE models granite-moe-1b-a400m and
kimi-k2-1t-a32b with their load-balance loss in the loss (kimi-k2 only
with ``--reduced``), the recurrent mamba2-130m and recurrentgemma-2b, and
the encoder-decoder seamless-m4t-large-v2, fed ``src_embeds`` (B, seq,
d_model) of standard normal float32 frames with each batch, as the
reference's driver feeds it.  The frames are drawn on the host from a
``torch.Generator`` seeded by (``--seed`` + 1, step): another stream than
the reference's ``jax.random`` one, as the weights and the noise of the
stochastic modes already are.

``--mesh DATA,MODEL`` runs the sharded FSDP+TP step (``train.steps``) on a
(data, model) mesh over the ranks of a ``torchrun`` job (DATA x MODEL of
them; ``env://`` rendezvous, NCCL on the card, gloo with ``--device
cpu``), for every ``--arch``; every rank draws the same global batch and
keeps its rows, and rank 0 alone prints:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch granite-moe-1b-a400m --reduced --device cpu --mesh 2,2 --steps 8 --batch 4 \
      --seq 16
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager, shard_train_state
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import apply_approx, apply_quality, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.engine import modes as engine_modes
from repro_torch.launch.mesh import join_mesh
from repro_torch.models.layers import fold_seed
from repro_torch.models.registry import build_model
from repro_torch.runtime.fault import FailureInjector, StragglerMonitor, run_loop
from repro_torch.train.steps import init_train_state, make_train_step, shard_batch

__all__ = ["main"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--opt-bits", type=int, default=32, choices=[8, 32])
    ap.add_argument("--compress", type=int, default=0, choices=[0, 8])
    ap.add_argument("--approx-mode", default=None, choices=engine_modes.list_modes(),
                    help="deploy the paper technique via a registered engine mode")
    ap.add_argument("--approx-n", type=int, default=8)
    ap.add_argument("--approx-t", type=int, default=None,
                    help="splitting point; default: resolved by the "
                         "engine.config controller for --approx-n "
                         "(balanced-tier budget)")
    ap.add_argument("--quality-tier", default=None,
                    help="accuracy tier (engine.config): per-GEMM-class "
                         "(n, t, mode) resolved against the tier's error "
                         "budgets; mutually exclusive with --approx-mode")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--inject-failures", default="",
                    help="comma-separated steps at which to raise (fault-tolerance demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default=None, help="write metrics history JSON here")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default cuda; cpu runs the plain PyTorch versions")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="the sharded FSDP+TP step on a (data, model) mesh over the ranks "
                         "of a torchrun job")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = _join_mesh(ap, args.mesh, device) if args.mesh else None
    try:
        _train(ap, args, device, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _join_mesh(ap, spec: str, device):
    """Join the ``torchrun`` job (``env://``) and make its (data, model) mesh."""
    try:
        return join_mesh(spec, device)
    except ValueError as e:
        ap.error(str(e))


def _train(ap, args, device, mesh) -> None:
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)  # only rank 0 prints
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.approx_mode and args.quality_tier:
        ap.error("--approx-mode and --quality-tier are mutually exclusive "
                 "(the tier owns the mode)")
    if args.approx_mode:
        cfg = apply_approx(cfg, n=args.approx_n, t=args.approx_t, mode=args.approx_mode)
    elif args.quality_tier:
        cfg = apply_quality(cfg, args.quality_tier, n=args.approx_n)
    cfg = dataclasses.replace(cfg, scan_layers=True)

    tcfg = TrainConfig(
        learning_rate=args.lr,
        total_steps=args.steps,
        warmup_steps=max(10, args.steps // 20),
        grad_accum=args.grad_accum,
        opt_state_bits=args.opt_bits,
        grad_compress_bits=args.compress,
        seed=args.seed,
    )
    model = build_model(cfg)
    state = init_train_state(model, tcfg, args.seed, device=device)
    n_params = model.param_count(state.params)
    say(f"arch={cfg.name} params={n_params/1e6:.1f}M devices="
        f"{1 if mesh is None else mesh.size()}")
    if mesh is not None:
        state = shard_train_state(state, mesh)

    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed,
    ))

    def batch_fn(step: int) -> dict:
        batch = {k: torch.as_tensor(v, device=device) for k, v in data.batch(step).items()}
        if cfg.is_encdec:
            gen = torch.Generator().manual_seed(fold_seed(args.seed + 1, step))
            src = torch.randn((args.batch, args.seq, cfg.d_model), generator=gen)
            batch["src_embeds"] = src.to(device)
        return batch if mesh is None else shard_batch(batch, mesh, tcfg.grad_accum)

    step_fn = make_train_step(model, tcfg, mesh=mesh)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    injector = None
    if args.inject_failures:
        injector = FailureInjector(tuple(int(s) for s in args.inject_failures.split(",")))

    result = run_loop(
        state, step_fn, batch_fn,
        total_steps=args.steps,
        ckpt=ckpt,
        checkpoint_every=args.ckpt_every if ckpt else 0,
        injector=injector,
        monitor=StragglerMonitor(),
        log_every=args.log_every if rank0 else 0,
    )
    first = np.mean([h["loss"] for h in result.metrics_history[:10]])
    last = np.mean([h["loss"] for h in result.metrics_history[-10:]])
    say(f"loss {first:.4f} -> {last:.4f}  failures={result.failures} "
        f"restarts={result.restarts} stragglers={len(result.slow_steps)}")
    if args.out and rank0:
        with open(args.out, "w") as f:
            json.dump(result.metrics_history, f)


if __name__ == "__main__":
    main()
