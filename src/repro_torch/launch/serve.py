"""Serving CLI: the continuous scheduler of ``repro_torch.serve`` on one device.

Counterpart of ``repro/launch/serve.py`` in the closed loop, printing the
same summary lines.  Runs on ``cuda`` unless ``--device cpu`` is given;
without a GPU and without that flag it raises.  Weights are random, made
from ``--seed``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --quality-tier balanced --requests 8 --batch 4 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \
      --device cpu --requests 4 --batch 2 --gen 4

Options of the reference that the port does not run yet (``--loop open``,
``--policy``, ``--strategy speculative``, ``--data-parallel``,
``--scheduler static``) raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import apply_approx, get_config
from repro_torch.device import resolve_device
from repro_torch.engine import config as engine_config
from repro_torch.engine import modes as engine_modes
from repro_torch.models.registry import build_model
from repro_torch.serve import continuous_serve_loop, synth_requests
from repro_torch.serve.stats import percentile

__all__ = ["main"]

_ROADMAP_SERVE = "ROADMAP.md, 'Modules to port' item 7"


def _not_ported(what: str, item: str = _ROADMAP_SERVE):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--approx-mode", default=None, choices=engine_modes.list_modes())
    ap.add_argument("--quality-tier", default=None, choices=engine_config.list_tiers(),
                    help="accuracy tier for the run (mutually exclusive with --approx-mode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default cuda; cpu runs the plain PyTorch versions")
    ap.add_argument("--scheduler", default="continuous", choices=("continuous", "static"))
    ap.add_argument("--vary-budget", action="store_true",
                    help="draw per-request budgets in [1, gen] instead of gen")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="retire a row early when it emits this token id")
    ap.add_argument("--data-parallel", action="store_true")
    ap.add_argument("--loop", default="closed", choices=("closed", "open"))
    ap.add_argument("--policy", default=None)
    ap.add_argument("--strategy", default="greedy", choices=("greedy", "speculative"))
    args = ap.parse_args(argv)

    if args.scheduler == "static":
        _not_ported("--scheduler static (the static-batch loop)")
    if args.loop == "open" or args.policy is not None:
        _not_ported("open-loop admission (--loop open, --policy)")
    if args.strategy == "speculative":
        _not_ported("--strategy speculative")
    if args.data_parallel:
        _not_ported("--data-parallel", "ROADMAP.md, 'Modules to port' item 11")
    if args.approx_mode and args.quality_tier:
        ap.error("--approx-mode and --quality-tier are mutually exclusive "
                 "(the tier owns the mode)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.approx_mode:
        cfg = apply_approx(cfg, mode=args.approx_mode)
    if args.quality_tier:
        print(f"# {engine_config.resolve_tier(args.quality_tier).describe()}")

    model = build_model(cfg)
    params = model.init_params(args.seed, device=device)
    queue = synth_requests(
        args.requests, prompt_len=args.prompt_len, gen=args.gen,
        vocab_size=cfg.vocab_size, seed=args.seed, vary_budget=args.vary_budget,
        eos_id=args.eos_id, quality=args.quality_tier,
    )
    with torch.inference_mode():  # the parameters are trainable: record no graph
        result = continuous_serve_loop(
            model, params, queue, batch_size=args.batch, prompt_len=args.prompt_len,
            max_new=args.gen, quality=args.quality_tier,
        )
    print(result.stats.summary())
    lat = result.stats.request_latencies_s
    if lat:
        print(
            f"per-request latency p50 {1e3 * percentile(lat, 50):.0f}ms "
            f"p95 {1e3 * percentile(lat, 95):.0f}ms over {len(lat)} requests"
        )


if __name__ == "__main__":
    main()
