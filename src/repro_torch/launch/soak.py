"""Soak CLI: long traffic-realistic runs against the serving schedulers.

Counterpart of ``repro/launch/soak.py``, a thin command line over
:func:`repro_torch.serve.soak.run_soak`: picks a workload preset from
``repro_torch.serve.workload``,
streams it through the continuous (or static) scheduler in bounded
windows, prints a per-window audit line, and exits non-zero on any
invariant violation — slot leaks, lost/duplicate serves, per-row
write-position violations, TTFT-p99 drift beyond ``--drift-limit``, or
a failed parity spot-check.

  # a long soak on the card (~20k requests)
  PYTHONPATH=src python -m repro_torch.launch.soak --arch qwen3-0.6b --reduced \
      --workload bursty --requests 20000 --batch 8 --prompt-len 16 --gen 8 \
      --window 1024 --spot-check 8 --drift-limit 50

  # open-loop clocked admission with SLO-adaptive tier degradation, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.soak --arch qwen3-0.6b --reduced \
      --device cpu --workload bursty --loop open --policy slo-adaptive \
      --slo-ttft-ms 50 --requests 256 --batch 4 --window 64

Runs on ``cuda`` unless ``--device cpu`` is given; weights are random,
made from ``--seed``.

``--json`` writes the report's summary row plus the per-window audits,
seed included, so a red run reproduces from the artifact alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.engine import config as engine_config
from repro_torch.models.registry import build_model
from repro_torch.serve.policy import POLICIES
from repro_torch.serve.soak import run_soak
from repro_torch.serve.strategy import SelfSpeculative
from repro_torch.serve.workload import PRESETS, preset_spec

__all__ = ["main"]


def _parse_tier_mix(text):
    """``"balanced=3,none=1"`` -> ((\"balanced\", 3.0), (None, 1.0))."""
    if not text:
        return ()
    mix = []
    for part in text.split(","):
        name, _, weight = part.partition("=")
        name = name.strip()
        mix.append((None if name in ("none", "") else name,
                    float(weight) if weight else 1.0))
    return tuple(mix)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced() smoke config")
    ap.add_argument("--workload", default="bursty", choices=sorted(PRESETS),
                    help="traffic preset (arrival process + length tails)")
    ap.add_argument("--requests", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--window", type=int, default=1024,
                    help="requests per bounded-memory audit window")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default cuda; cpu runs the plain PyTorch versions")
    ap.add_argument("--scheduler", default="continuous",
                    choices=("continuous", "static"))
    ap.add_argument("--loop", default="closed", choices=("closed", "open"),
                    help="closed: each window drains as a pre-filled queue; "
                         "open: arrival-clocked admission against the "
                         "window's arrival times (continuous only)")
    ap.add_argument("--policy", default=None, choices=sorted(POLICIES),
                    help="admission policy (open loop): static / "
                         "slo-adaptive / reject; default static")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="stamp a TTFT SLO (ms) on every request so the "
                         "report carries slo attainment")
    ap.add_argument("--step-time-ms", type=float, default=10.0,
                    help="virtual-clock cost of one exact decode step "
                         "(open loop)")
    ap.add_argument("--clock", default="virtual", choices=("virtual", "wall"),
                    help="open loop: deterministic virtual clock (default) "
                         "or real sleeping wall clock")
    ap.add_argument("--quality-tier", default=None,
                    choices=engine_config.list_tiers(),
                    help="pool accuracy tier; tier-tagged requests are "
                         "checked against it at admission")
    ap.add_argument("--strategy", default="greedy",
                    choices=("greedy", "speculative"),
                    help="decode strategy (continuous only); speculative "
                         "pools still pass the parity spot-checks because "
                         "speculative output bit-matches plain decode, and "
                         "presets with a spec_fraction (churn/bursty) tag a "
                         "request fraction to exercise mid-stream switching")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculative: draft tokens proposed per round")
    ap.add_argument("--draft-tier", default="draft",
                    choices=engine_config.list_tiers(),
                    help="speculative: accuracy tier proposing draft tokens")
    ap.add_argument("--verify-tier", default=None,
                    choices=engine_config.list_tiers(),
                    help="speculative: tier whose engine verifies (default: "
                         "the pool's own tier)")
    ap.add_argument("--tier-mix", default="",
                    help="weighted request tier tags, e.g. 'balanced=3,none=1' "
                         "(tags must match --quality-tier or be none)")
    ap.add_argument("--drift-limit", type=float, default=50.0,
                    help="max allowed later-window TTFT p99 / first-window p99 "
                         "(<= 0 disables the drift gate)")
    ap.add_argument("--spot-check", type=int, default=4,
                    help="request ids re-served alone/unpadded and bit-compared")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the report (summary row + per-window audits)")
    args = ap.parse_args(argv)

    strategy = None
    if args.strategy == "speculative":
        if args.scheduler != "continuous":
            ap.error("--strategy speculative requires --scheduler continuous")
        strategy = SelfSpeculative(
            k=args.spec_k, draft_tier=args.draft_tier,
            verify_tier=args.verify_tier,
        )

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init_params(args.seed, device=device)
    spec = preset_spec(
        args.workload, requests=args.requests, prompt_len=args.prompt_len,
        max_new=args.gen, vocab_size=cfg.vocab_size,
        tier_mix=_parse_tier_mix(args.tier_mix),
        slo_ttft_s=args.slo_ttft_ms / 1e3 if args.slo_ttft_ms else None,
    )

    def progress(w):
        tail = f"{1e3 * w.ttft_p99_s:.0f}ms" if w.ttft_p99_s is not None else "n/a"
        flag = "" if not w.violations else f"  !! {'; '.join(w.violations)}"
        print(f"# window {w.index:4d}: {w.requests} reqs, {w.tokens_out} toks, "
              f"{w.slot_utilization:.0%} util, ttft p99 {tail}{flag}", flush=True)

    with torch.inference_mode():  # the parameters are trainable: record no graph
        report = run_soak(
            model, params, spec,
            batch_size=args.batch, seed=args.seed, window_size=args.window,
            scheduler=args.scheduler, quality=args.quality_tier,
            drift_limit=args.drift_limit if args.drift_limit > 0 else None,
            spot_check=args.spot_check, progress=progress,
            loop=args.loop, policy=args.policy,
            step_time_s=args.step_time_ms / 1e3, clock=args.clock,
            strategy=strategy,
        )

    print(report.describe())
    if args.json:
        doc = {
            "summary": report.summary_row(),
            "windows": [dataclasses.asdict(w) for w in report.windows],
            "violations": list(report.violations),
        }
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True, default=float)
            f.write("\n")
        print(f"# wrote {args.json}")
    for v in report.violations:
        print(f"VIOLATION: {v}", file=sys.stderr)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
