"""Serving CLI: the schedulers of ``repro_torch.serve`` on one device.

Counterpart of ``repro/launch/serve.py``, with the same flags and summary
lines.  Runs on ``cuda`` unless ``--device cpu`` is given; without a GPU
and without that flag it raises.  Weights are random, made from ``--seed``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --quality-tier balanced --requests 8 --batch 4 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \
      --device cpu --requests 4 --batch 2 --gen 4

``--loop open`` draws the requests from a ``--workload`` preset with
arrival times, admissible once the (virtual or wall) clock passes them,
with a ``--policy`` (static / slo-adaptive / reject) choosing admission
and the pool's tier per tick; ``--strategy speculative`` decodes
self-speculatively (``--spec-k`` draft-tier proposals verified by one
batched forward); ``--scheduler static`` runs the static-batch loop:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \
      --device cpu --loop open --workload bursty --policy slo-adaptive \
      --slo-ttft-ms 50 --requests 64 --batch 4 --gen 8

``--data-parallel`` raises ``NotImplementedError`` (ROADMAP.md, 'Modules
to port' item 11).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import apply_approx, get_config
from repro_torch.device import resolve_device
from repro_torch.engine import config as engine_config
from repro_torch.engine import modes as engine_modes
from repro_torch.models.registry import build_model
from repro_torch.serve import (
    SelfSpeculative,
    continuous_serve_loop,
    get_policy,
    static_serve_loop,
    supports_continuous,
    synth_requests,
)
from repro_torch.serve.policy import POLICIES
from repro_torch.serve.stats import percentile
from repro_torch.serve.workload import PRESETS, generate, preset_spec

__all__ = ["main"]


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
                    help="accuracy tier for the run; requests are tagged with it and "
                         "checked at admission (mutually exclusive with --approx-mode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default cuda; cpu runs the plain PyTorch versions")
    ap.add_argument("--scheduler", default=None, choices=("continuous", "static"),
                    help="continuous: per-round retirement and admission (the default "
                         "where supported); static: the re-batch-at-drain loop")
    ap.add_argument("--vary-budget", action="store_true",
                    help="draw per-request budgets in [1, gen] instead of gen")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="retire a row early when it emits this token id")
    ap.add_argument("--data-parallel", action="store_true",
                    help="shard the decode batch over a device mesh (not ported yet)")
    ap.add_argument("--loop", default="closed", choices=("closed", "open"),
                    help="closed: drain a pre-filled queue; open: arrival-clocked "
                         "admission (continuous scheduler only)")
    ap.add_argument("--workload", default="bursty", choices=sorted(PRESETS),
                    help="open loop: traffic preset supplying arrivals and length tails")
    ap.add_argument("--policy", default=None, choices=sorted(POLICIES),
                    help="admission policy for --loop open")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="stamp a TTFT SLO (ms) on every open-loop request")
    ap.add_argument("--step-time-ms", type=float, default=10.0,
                    help="virtual-clock cost of one exact decode step (open loop; "
                         "tiers scale it by their cycle factor)")
    ap.add_argument("--clock", default="virtual", choices=("virtual", "wall"),
                    help="open loop: deterministic virtual clock or real wall clock")
    ap.add_argument("--strategy", default="greedy", choices=("greedy", "speculative"),
                    help="decode strategy (continuous scheduler only): greedy rounds, "
                         "or k draft-tier proposals verified by one batched forward")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculative: draft tokens proposed per round")
    ap.add_argument("--draft-tier", default="draft", choices=engine_config.list_tiers(),
                    help="speculative: accuracy tier proposing draft tokens")
    ap.add_argument("--verify-tier", default=None, choices=engine_config.list_tiers(),
                    help="speculative: tier whose engine verifies (default: the pool's)")
    args = ap.parse_args(argv)

    if args.data_parallel:
        raise NotImplementedError(
            "--data-parallel is not ported yet (ROADMAP.md, 'Modules to port' item 11)"
        )
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

    scheduler = args.scheduler
    if scheduler is None:
        scheduler = "continuous" if supports_continuous(cfg) else "static"
        if scheduler == "static":
            print(f"# {cfg.name}: auto-selected --scheduler static "
                  f"(continuous supports attention-only decoder stacks)")
    if args.loop == "open" and scheduler != "continuous":
        ap.error("--loop open requires --scheduler continuous")
    if args.policy is not None and args.loop != "open":
        ap.error("--policy only applies to --loop open (closed-loop "
                 "admission is the implicit static policy)")
    if args.strategy == "speculative" and scheduler != "continuous":
        ap.error("--strategy speculative requires --scheduler continuous")

    strategy = None
    if args.strategy == "speculative":
        strategy = SelfSpeculative(k=args.spec_k, draft_tier=args.draft_tier,
                                   verify_tier=args.verify_tier)
        verify = args.verify_tier or args.quality_tier or "exact"
        est = engine_config.accept_rate_estimate(args.draft_tier, verify)
        print(f"# speculative: k={args.spec_k} draft={args.draft_tier} "
              f"verify={verify}, accept-rate lower bound {est:.1%} "
              f"(engine_config.accept_rate_estimate)")

    model = build_model(cfg)
    params = model.init_params(args.seed, device=device)

    run_kwargs = {}
    if args.loop == "open":
        spec = preset_spec(
            args.workload, requests=args.requests, prompt_len=args.prompt_len,
            max_new=args.gen, vocab_size=cfg.vocab_size,
            slo_ttft_s=args.slo_ttft_ms / 1e3 if args.slo_ttft_ms else None,
        )
        draw = generate(spec, seed=args.seed)
        queue = list(draw.requests)
        run_kwargs = dict(
            arrivals_s=list(draw.arrivals_s),
            policy=get_policy(args.policy or "static"),
            step_time_s=args.step_time_ms / 1e3,
            clock=args.clock,
        )
        print(f"# open loop: {args.workload} preset, offered "
              f"{draw.offered_rps:.1f} rps, policy {run_kwargs['policy'].name}")
    else:
        queue = synth_requests(
            args.requests, prompt_len=args.prompt_len, gen=args.gen,
            vocab_size=cfg.vocab_size, seed=args.seed, vary_budget=args.vary_budget,
            eos_id=args.eos_id, quality=args.quality_tier,
        )
    with torch.inference_mode():  # the parameters are trainable: record no graph
        if scheduler == "continuous":
            result = continuous_serve_loop(
                model, params, queue, batch_size=args.batch, prompt_len=args.prompt_len,
                max_new=args.gen, quality=args.quality_tier, strategy=strategy,
                **run_kwargs,
            )
        else:
            result = static_serve_loop(
                model, params, queue, batch_size=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, seed=args.seed, quality=args.quality_tier,
            )
    print(result.stats.summary())
    ar = result.stats.accept_rate
    if ar is not None:
        print(f"# speculative accept: {result.stats.spec_accepted}/"
              f"{result.stats.spec_proposed} draft tokens ({ar:.1%}), "
              f"{result.stats.spec_rolled_back} rolled back over "
              f"{result.stats.spec_rounds} speculated rounds")
    lat = result.stats.request_latencies_s
    if lat:
        print(
            f"per-request latency p50 {1e3 * percentile(lat, 50):.0f}ms "
            f"p95 {1e3 * percentile(lat, 95):.0f}ms over {len(lat)} requests"
        )
    for sw in result.tier_switches:
        print(f"# tier switch @ step {sw.step} t={sw.now_s:.3f}s: "
              f"{sw.from_tier} -> {sw.to_tier} ({sw.reason})")


if __name__ == "__main__":
    main()
