#!/usr/bin/env python3
"""Compare checkouts of the port on one card: the serve decode's time per
call, the closed-loop serve runs end to end, and train run (a)'s losses,
step by step.

    python3 scripts/compare_trees.py --decode OLD NEW NEW OLD --serve OLD NEW NEW OLD \
        --train OLD NEW --loss OLD NEW

Each argument is a directory that holds ``src/repro_torch`` (``.`` for this
checkout).  Every tree's kernels are built first, one ``nvcc`` per source,
all at once.  Then, each in a process of its own and in the order given:

- ``--decode``: ``flash_decode`` at chip_smoke's serve shape (q (4, 16,
  128) over 48 cache slots, 8 KV heads, bf16), its time per call over a
  loop of 200 calls (the host's work and the launch included, as
  chip_smoke's ``ms``), five loops, and its device time (``graph_ms``);
  SDPA's, on the same inputs, beside it;
- ``--serve``: chip_smoke's closed-loop serve runs of full-width
  qwen3-0.6b at tiers ``exact`` and ``draft`` and, with
  ``attn_impl="pallas"``, at ``exact`` (16 requests each): tok/s, and the
  host-clock ms of one decode step and one pool prefill after each;
- ``--train``: chip_smoke's train run (a), paper-multiplier with
  ``attn_impl="pallas"``, 16 steps from seed 0, and its loss at each step;
- ``--loss``: that run's first loss (seed-0 weights, batch 0, no update)
  through the flash kernels (``attn_impl="pallas"``), through the plain
  attention on the card (``"xla"``), and through the plain attention with
  its output nudged by a relative 2^-20 (a random sign per element, three
  seeds): how far the loss moves for a change of attention's output the
  size of the kernels' own rounding.

Each process prints ``result: {...}``; the last line is one JSON object of
every result, in the order run.  It needs a CUDA card and imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN_KERNELS = ("lut_matmul", "flash_attention", "flash_attention_bwd")


def _use(tree: str):
    """Import the port from ``tree`` and chip_smoke's helpers from this checkout."""
    sys.path.insert(0, str(pathlib.Path(tree).resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch, chip_smoke


def run_decode(tree: str) -> dict:
    torch, cs = _use(tree)
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    b, t = cs.SERVE["batch"], cs.CACHE
    q, k, v, q_pos, k_pos = cs.attention_inputs(b, 1, t, seed=302)
    scale = cs.HEAD_DIM**-0.5
    kern = lambda: fa.flash_decode(q[:, 0], k, v, q_pos, k_pos, scale=scale)
    allow = fa.allow_mask(q_pos.reshape(b, 1), k_pos, causal=True, window=None)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allow[:, None],
                                                  scale=scale, enable_gqa=True)
    torch.testing.assert_close(kern(), fa.flash_decode_plain(q[:, 0], k, v, q_pos, k_pos,
                                                             scale=scale), rtol=2e-5, atol=2e-5)
    loops = [cs.cuda_ms(kern, reps=200, warmup=20) for _ in range(5)]
    sdpa_loops = [cs.cuda_ms(sdpa, reps=200, warmup=20) for _ in range(5)]
    return dict(what="decode", tree=tree, loop_ms=loops, device_ms=cs.graph_ms(kern),
                sdpa_loop_ms=sdpa_loops, sdpa_device_ms=cs.graph_ms(sdpa))


def run_serve(tree: str) -> dict:
    _, cs = _use(tree)
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config("qwen3-0.6b")
    model = build_model(cfg)
    params = model.init_params(0, device="cuda")
    pallas = build_model(dataclasses.replace(cfg, attn_impl="pallas"))
    got = {}
    for label, m, quality in (("exact", model, "exact"), ("draft", model, "draft"),
                              ("pallas exact", pallas, "exact")):
        run = cs.phase_serve(label, params, m, quality=quality, requests=cs.SERVE["requests"])
        got[label] = {k: run[k] for k in ("tok_s", "decode_ms", "prefill_ms")}
    return dict(what="serve", tree=tree, **got)


def run_train(tree: str) -> dict:
    _, cs = _use(tree)
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model

    model = build_model(dataclasses.replace(get_config("paper-multiplier"), attn_impl="pallas"))
    got = cs.phase_train("paper-multiplier pallas", model,
                         expect=("lut_matmul", "flash_attention"))
    return dict(what="train", tree=tree, losses=got["losses"], first=got["first"],
                last=got["last"])


def run_loss(tree: str) -> dict:
    torch, cs = _use(tree)
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import attention
    from repro_torch.models.registry import build_model
    from repro_torch.models.layers import fold_seed
    from repro_torch.train.steps import loss_fn

    cfg = get_config("paper-multiplier")
    b, seq = cs.TRAIN["batch"], cs.TRAIN["seq"]
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=b,
                                  seed=0))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in data.batch(0).items()}
    got = {}

    def loss(impl: str) -> float:
        model = build_model(dataclasses.replace(cfg, attn_impl=impl))
        params = model.init_params(0, device="cuda")
        with torch.no_grad():
            return loss_fn(params, batch, fold_seed(0, 0), model)[0].item()

    got["pallas"], got["plain"] = loss("pallas"), loss("xla")
    plain = attention.attend
    for seed in (1, 2, 3):
        gen = torch.Generator(device="cuda").manual_seed(seed)

        def nudged(*args, **kw):
            out = plain(*args, **kw)
            sign = torch.randint(0, 2, out.shape, generator=gen, device=out.device) * 2 - 1
            return out * (1 + 2.0**-20 * sign)

        attention.attend = nudged
        try:
            got[f"plain_nudged_{seed}"] = loss("xla")
        finally:
            attention.attend = plain
    return dict(what="loss", tree=tree, **got)


def build(trees: dict) -> None:
    """Build each tree's kernels, every tree at once."""
    procs = []
    for tree, names in trees.items():
        src = pathlib.Path(tree).resolve() / "src"
        code = (f"import sys; sys.path.insert(0, {str(src)!r}); "
                f"from repro_torch.kernels import build; build.build_all({tuple(names)!r})")
        procs.append((tree, subprocess.Popen([sys.executable, "-c", code])))
    failed = [tree for tree, proc in procs if proc.wait() != 0]
    if failed:
        raise SystemExit(f"the build failed in {failed}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--decode", nargs="*", default=[], metavar="TREE")
    ap.add_argument("--serve", nargs="*", default=[], metavar="TREE")
    ap.add_argument("--train", nargs="*", default=[], metavar="TREE")
    ap.add_argument("--loss", nargs="*", default=[], metavar="TREE")
    ap.add_argument("--one", nargs=2, metavar=("WHAT", "TREE"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        what, tree = args.one
        run = {"decode": run_decode, "serve": run_serve, "train": run_train,
               "loss": run_loss}[what]
        print("result: " + json.dumps(run(tree)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs a GPU")
    trees: dict = {}
    for tree in args.decode:
        trees.setdefault(tree, set()).add("flash_attention")
    for tree in args.serve:
        trees.setdefault(tree, set()).update(("flash_attention", "packed_matmul"))
    for tree in args.train + args.loss:
        trees.setdefault(tree, set()).update(TRAIN_KERNELS)
    t0 = time.perf_counter()
    build(trees)
    print(f"build: {sorted(trees)} in {time.perf_counter() - t0:.1f}s", flush=True)
    results = []
    runs = [(what, tree) for what in ("decode", "serve", "train", "loss")
            for tree in getattr(args, what)]
    for what, tree in runs:
        out = subprocess.run([sys.executable, __file__, "--one", what, tree], check=True,
                             stdout=subprocess.PIPE, text=True).stdout
        print(out, end="", flush=True)
        results.append(json.loads(out.rsplit("result: ", 1)[1]))
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
