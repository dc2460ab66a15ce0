#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py    # everything below, on one card

Phases, one line each (or a few):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, compute capability (must be 9.0), TF32 off;
2. build: every kernel of ``src/repro_torch/kernels/csrc`` with one nvcc
   per source, all started together;
3. kernels: each kernel's wrapper against its plain PyTorch version on
   the card at the main path's shapes (M in {decode batch, admission
   prompt, batch x prompt}, (K, N) the projections of qwen3-0.6b), plus
   a sweep over (n, t); results must be bit-equal.  Prints the kernel's
   time, the plain version's, the bound (the larger of the bytes at
   3.35 TB/s and the operations at their rate: table lookups at the
   shared-memory rate, the least integer operations of the recurrence at
   the SMs' int32 issue rate, lane products on the int8 tensor cores) and
   one torch.matmul on the dequantized f32 operands, a yardstick the port
   never calls;
4. reference: ``engine.matmul`` on the card against the CPU reference
   bodies at a small shape (bit-equal), and reduced qwen3-0.6b prefill
   logits, exact and bitexact, on the card against the CPU (float32,
   rtol/atol 1e-4: sums run in another order);
5. serve: the continuous scheduler on full-width qwen3-0.6b (28 layers,
   d_model 1024, vocab 151936, bf16, weights from a seed) at tier
   ``exact`` (no kernel: the yardstick), tier ``balanced`` (lut_matmul),
   tier ``draft`` (packed_matmul) and ``--approx-mode seqmul``
   (seqmul_matmul).  Every launch count is set to 0 just before each run
   and read just after.  After each run, one pool prefill and one decode
   step give the launches and host time per step, and a profiler pass
   over three decode steps the device's busy share;
6. the kernel table as JSON, then ``{"ok": true, "device": {...}}`` as the
   last line.

Any failed check exits non-zero before the last line is printed; so does
a machine without CUDA, or a directory without the repository's ``src``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_CLK_PER_SM = 64  # Hopper SM: 4 partitions x 16 INT32 lanes
SMEM_LOOKUPS_PER_CLK_PER_SM = 32  # 32 banks, one 4-byte word each per clock
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores (NVIDIA data sheet)

# qwen3-0.6b projections (K, N): q, k/v, o, mlp up/gate, mlp down
PROJECTIONS = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]
SERVE = dict(requests=8, batch=4, prompt=32, gen=16)
MAIN_SHAPE = (SERVE["batch"] * SERVE["prompt"], 1024, 3072)  # reported in the JSON


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- timing
def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------- kernels
class Card:
    """The rates the bounds use, read from this run's card."""

    def __init__(self):
        import torch

        props = torch.cuda.get_device_properties(0)
        self.sms = props.multi_processor_count
        self.clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
        self.int32_ops_per_s = INT32_OPS_PER_CLK_PER_SM * self.sms * self.clock_hz
        self.lookups_per_s = SMEM_LOOKUPS_PER_CLK_PER_SM * self.sms * self.clock_hz

    def bound(self, nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
        return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def seqmul_ops_per_product(n: int) -> int:
    """The least int32 operations one approximate product of the recurrence
    needs, one Hopper instruction each: 8 per cycle and 7 per product, the
    count set out in the note of ``csrc/seqmul_matmul.cu``.  Every product
    runs all n cycles, whatever its operands."""
    return 8 * n + 7


def operands(m, k, n, bits, seed):
    """Quantized operands of one main-path GEMM, as the mode bodies make them."""
    import torch

    from repro_torch.engine.modes import quantize_operands

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda")
    w = torch.randn((k, n), generator=g, device="cuda") * k**-0.5
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, bits)
    return x, w, mx, sx, mw, sw, scale


def kernel_cases():
    """(kernel, M, K, N, n, t) at the main-path shapes plus the sweep."""
    ms = (SERVE["batch"], SERVE["prompt"], SERVE["batch"] * SERVE["prompt"])
    cases = []
    for name in ("lut_matmul", "seqmul_matmul", "packed_matmul"):
        for m in ms:
            for k, n in PROJECTIONS:
                cases.append((name, m, k, n, 8, 4))
    for n_bits, t in ((8, 1), (8, 2), (8, 6), (4, 2), (6, 3)):
        cases.append(("lut_matmul", SERVE["batch"], 1024, 3072, n_bits, t))
        cases.append(("seqmul_matmul", SERVE["batch"], 1024, 3072, n_bits, t))
    for m in (SERVE["batch"], SERVE["batch"] * SERVE["prompt"]):
        cases.append(("seqmul_matmul", m, 1024, 3072, 12, 6))
        cases.append(("seqmul_matmul", m, 3072, 1024, 12, 5))
    cases.append(("packed_matmul", SERVE["batch"], 3072, 1024, 15, 1))
    cases.append(("packed_matmul", SERVE["batch"] * SERVE["prompt"], 1024, 3072, 12, 1))
    return cases


def run_kernel_case(card: Card, name, m, k, n, bits, t, seed, timed: bool):
    import torch

    from repro_torch.engine import artifacts
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import seqmul_matmul as sm

    _, _, mx, sx, mw, sw, scale = operands(m, k, n, bits, seed)
    if name == "lut_matmul":
        lut = artifacts.product_lut_u16(bits, t, True, mx.device)
        a, b = mx.to(torch.uint8), mw.to(torch.uint8)
        kern = lambda: lm.lut_matmul(lut, a, sx, b, sw, n=bits)
        plain = lambda: lm.lut_matmul_plain(lut, a, sx, b, sw, n=bits)
        nbytes = lut.numel() * 2 + 2 * m * k + 2 * k * n + 4 * m * n
        bound = card.bound(nbytes, m * k * n, card.lookups_per_s)
    elif name == "seqmul_matmul":
        a, b = mx.to(torch.int16), mw.to(torch.int16)
        kern = lambda: sm.seqmul_matmul(a, sx, b, sw, n=bits, t=t)
        plain = lambda: sm.seqmul_matmul_plain(a, sx, b, sw, n=bits, t=t)
        nbytes = 3 * m * k + 3 * k * n + 4 * m * n
        ops = m * k * n * seqmul_ops_per_product(bits)
        bound = card.bound(nbytes, ops, card.int32_ops_per_s)
    else:
        pa = pm.pack_i16_pairs(mx * sx.to(torch.int32), dim=1)
        pb = pm.pack_i16_pairs(mw * sw.to(torch.int32), dim=0)
        kern = lambda: pm.packed_matmul(pa, pb, n=bits)
        plain = lambda: pm.packed_matmul_plain(pa, pb)
        nbytes = 4 * (pa.numel() + pb.numel() + m * n)
        # the least time: int16 lanes split into int8 halves on the tensor
        # cores, 4 int8 products of 2 ops (multiply, add) per lane product
        bound = card.bound(nbytes, 8 * m * k * n, INT8_TENSOR_OPS_PER_S)
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(torch.equal(got, want),
          f"{name} M={m} K={k} N={n} n={bits} t={t}: kernel != plain (max |err| {err})")
    row = dict(name=name, shape=[m, k, n], n=bits, t=t, max_abs_err=err,
               bound_ms=bound[0], bound_by=bound[1])
    if timed:
        # the dequantized operands (the joint scale folded into the left one)
        xq, wq = (mx * sx).to(torch.float32) * scale, (mw * sw).to(torch.float32)
        row["ms"] = cuda_ms(kern, reps=20, warmup=2)
        row["plain_ms"] = cuda_ms(plain, reps=2)
        row["library_ms"] = cuda_ms(lambda: torch.matmul(xq, wq), reps=20, warmup=2)
    return row


def phase_kernels(card: Card) -> list:
    rows = []
    for i, (name, m, k, n, bits, t) in enumerate(kernel_cases()):
        timed = (bits, t) == (8, 4)  # the main path's (n, t)
        row = run_kernel_case(card, name, m, k, n, bits, t, seed=100 + i, timed=timed)
        rows.append(row)
        times = (
            f" ms {row['ms']:.4f} plain_ms {row['plain_ms']:.3f} "
            f"library_ms {row['library_ms']:.4f}" if "ms" in row else ""
        )
        print(f"kernel {name} M={m} K={k} N={n} n={bits} t={t}: bit-equal{times} "
              f"bound_ms {row['bound_ms']:.5f} ({row['bound_by']})", flush=True)
    return rows


# ------------------------------------------------------------ reference
def phase_reference() -> None:
    import torch

    from repro_torch import engine
    from repro_torch.configs.registry import apply_approx, get_config
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_prefill_step

    g = torch.Generator().manual_seed(7)
    x = torch.randn((16, 128), generator=g)
    w = torch.randn((128, 64), generator=g)
    for mode, n, t in (("bitexact", 8, 4), ("seqmul", 8, 4), ("seqmul", 12, 6), ("inject", 8, 4)):
        kw = dict(mode=mode, n=n, t=t)
        if mode == "inject":
            # the same noise on both sides: drawn once on the CPU, handed to both
            spec, p = engine.get_mode("inject"), engine.GemmParams(n, t, True, 8)
            (noise,) = spec.prepare(x, w, p, torch.Generator().manual_seed(1))
            want = spec.reference(x, w, p, noise)
            got = spec.cuda(x.cuda(), w.cuda(), p, noise.cuda()).cpu()
        else:
            want = engine.matmul(x, w, backend="reference", **kw)
            got = engine.matmul(x.cuda(), w.cuda(), backend="cuda", **kw).cpu()
        check(torch.equal(got, want), f"engine.matmul {mode} n={n} t={t}: card != CPU reference")
    print("reference: engine.matmul bitexact/seqmul(n=8,12)/inject on the card bit-equal "
          "to the CPU reference bodies at (16,128)x(128,64)", flush=True)

    for label, cfg in (("exact", get_config("qwen3-0.6b").reduced()),
                       ("bitexact", apply_approx(get_config("qwen3-0.6b").reduced(),
                                                 mode="bitexact", n=8, t=4))):
        model = build_model(cfg)
        cpu_params = model.init_params(0, device="cpu")
        gpu_params = model.init_params(0, device="cpu").cuda()
        toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(3))
        with torch.inference_mode():
            _, want = make_prefill_step(model, 24)(cpu_params, {"tokens": toks})
            _, got = make_prefill_step(model, 24)(gpu_params, {"tokens": toks.cuda()})
        got = got.cpu()
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"reduced {label} prefill: non-finite logits")
        # Both within rtol/atol 1e-4: the float sums (norms, attention, the
        # exact projections) run in another order on the card.  The bitexact
        # GEMMs are integer-exact on both sides, so they add nothing unless an
        # input lands on the other side of a quantizer rounding boundary,
        # which moves a logit by far more than 1e-4 and fails here.
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
              f"reduced {label} prefill: card vs CPU max |err| {err}")
        print(f"reference: reduced qwen3-0.6b {label} prefill logits card vs CPU "
              f"max |err| {err:.3e} (rtol/atol 1e-4)", flush=True)


# ---------------------------------------------------------------- serve
def phase_serve(label: str, params, model, *, quality=None, mode=None, expect, requests: int):
    """One closed-loop run of the scheduler; ``expect`` names the kernel
    the run must launch (None: the exact pool, which must launch none)."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs.registry import apply_approx
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ContinuousScheduler, synth_requests

    if mode is not None:
        model = build_model(apply_approx(model.cfg, mode=mode))
    cfg = model.cfg
    queue = synth_requests(requests, prompt_len=SERVE["prompt"], gen=SERVE["gen"],
                           vocab_size=cfg.vocab_size, seed=0, vary_budget=False,
                           quality=quality)
    sched = ContinuousScheduler(model, params, batch_size=SERVE["batch"],
                                prompt_len=SERVE["prompt"], max_new=SERVE["gen"],
                                quality=quality)
    bad_logits = []
    lm_head = params.lm_head

    def checked_lm_head(hidden):
        logits = lm_head(hidden)
        check(logits.shape[-1] == cfg.vocab_size, f"{label}: logits shape {tuple(logits.shape)}")
        bad_logits.append(torch.isnan(logits).any())
        return logits

    params.lm_head = checked_lm_head
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = sched.run(queue)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    finally:
        del params.lm_head
    st, acc = result.stats, result.accounting
    if expect is None:
        check(not any(counts.values()), f"{label}: a kernel ran in the exact pool ({counts})")
    else:
        check(counts[expect] > 0, f"{label}: {expect} was never launched ({counts})")
    check(st.requests == requests, f"{label}: served {st.requests} of {requests}")
    for r in queue:
        got = len(result.outputs[r.id])
        check(got == r.max_new, f"{label}: request {r.id} got {got} of {r.max_new} tokens")
    check(acc.slot_leaks == 0 and acc.position_violations == 0,
          f"{label}: slot accounting {acc}")
    check(not any(bool(b) for b in bad_logits), f"{label}: NaN logits")
    print(f"serve {label}: {st.summary()}; prefill {st.prefill_s:.3f}s decode "
          f"{st.decode_s:.3f}s over {st.decode_steps} steps; run incl. warmup {wall:.2f}s; "
          f"launches {counts}", flush=True)
    steps = step_breakdown(label, sched, params)
    return dict(counts=counts, tok_s=st.tokens_per_s, wall_s=st.wall_s, **steps)


def step_breakdown(label: str, sched, params) -> dict:
    """One pool prefill and one decode step of the pool's engine, outside
    the main path's count window: launches of each kernel per step, the
    host-clock time of each step, and a profiler pass over a few decode
    steps for the device's busy share and the kernels' share of it."""
    import torch

    from repro_torch import kernels

    eng = sched.engine_for(None)
    b, p = sched.batch_size, sched.prompt_len
    toks = torch.zeros((b, p), dtype=torch.int64, device="cuda")
    pos = torch.arange(p, device="cuda").expand(b, p)
    tok1 = toks[:, :1]
    at = torch.full((b,), p, dtype=torch.int64, device="cuda")
    with torch.inference_mode():
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches, _ = eng.prefill_pool(params, toks, pos)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        per_prefill = kernels.launch_counts()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng.decode(params, caches, tok1, at, at)[0].cpu()
        decode_ms = (time.perf_counter() - t0) * 1e3
        per_decode = kernels.launch_counts()
        busy_ms, kernel_ms, wall_ms, reps = profile_decode(eng, params, caches, tok1, at)
    kernels.reset_launch_counts()
    share = (f"device busy {busy_ms / wall_ms:.3f} of {wall_ms / reps:.2f} ms/step, own "
             f"kernels {kernel_ms / max(busy_ms, 1e-9):.3f} of busy" if busy_ms else
             "device busy share not measured (the profiler saw no device time)")
    print(f"serve {label}: pool prefill (M={b * p}) {prefill_ms:.2f} ms, launches "
          f"{per_prefill}; decode step (M={b}) {decode_ms:.2f} ms, launches {per_decode}; "
          f"{share}", flush=True)
    return dict(per_prefill=per_prefill, per_decode=per_decode, prefill_ms=prefill_ms,
                decode_ms=decode_ms, busy_share=busy_ms / wall_ms if busy_ms else None)


def profile_decode(eng, params, caches, tok, at, reps: int = 3):
    """Device time over ``reps`` decode steps: (busy ms, ms in the port's
    kernels, host-clock ms, reps).  Busy is the sum of kernel times on the
    one stream the steps use."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.decode(params, caches, tok, at, at)[0].cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = kernel_us = 0.0
    host = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is not None and "CUDA" not in str(ev.device_type):
            host.append((ev.self_cpu_time_total, ev.count, ev.key))
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        busy_us += dev_us
        if any(f"{name}_kernel" in ev.key for name in kernels.ALL):
            kernel_us += dev_us
    launches = sum(c for _, c, k in host if k.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    top = ", ".join(f"{k} {us / 1e3 / reps:.2f} ms x{c // reps}"
                    for us, c, k in sorted(host, reverse=True)[:6])
    print(f"profile: per decode step {launches / reps:.0f} launches through the CUDA runtime "
          f"seen; host self time by op: {top}", flush=True)
    return busy_us / 1e3, kernel_us / 1e3, wall_ms, reps


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        raise SmokeFailure(f"no src/repro_torch beside {pathlib.Path(__file__).name}")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this script needs a GPU")

    # 1. environment
    card_line = nvidia_smi("name,power.limit")
    print(card_line, flush=True)
    cap = torch.cuda.get_device_capability(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} capability {cap[0]}.{cap[1]} "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    check(cap == (9, 0), f"compute capability {cap}, expected (9, 0)")
    card = Card()
    print(f"env: {card.sms} SMs at max {card.clock_hz / 1e9:.3f} GHz: int32 "
          f"{card.int32_ops_per_s / 1e12:.2f} Tops/s, shared-memory lookups "
          f"{card.lookups_per_s / 1e12:.2f} T/s", flush=True)

    # 2. build
    from repro_torch import kernels
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {sorted(logs) or 'all cached'} in {time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "Used" in line:
                print(f"build: {name}: {line.strip()}", flush=True)

    # 3. kernels
    rows = phase_kernels(card)
    kernels.reset_launch_counts()

    # 4. reference
    phase_reference()
    kernels.reset_launch_counts()

    # 5. serve
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config("qwen3-0.6b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(0, device="cuda")
    torch.cuda.synchronize()
    print(f"serve: qwen3-0.6b {cfg.num_layers} layers, d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"{model.param_count(params) / 1e6:.1f}M params from seed 0 in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    phase_serve("exact", params, model, quality="exact", expect=None,
                requests=SERVE["requests"])
    runs = {
        "lut_matmul": phase_serve("balanced", params, model, quality="balanced",
                                  expect="lut_matmul", requests=SERVE["requests"]),
        "packed_matmul": phase_serve("draft", params, model, quality="draft",
                                     expect="packed_matmul", requests=SERVE["requests"]),
        "seqmul_matmul": phase_serve("seqmul", params, model, mode="seqmul",
                                     expect="seqmul_matmul", requests=SERVE["requests"] // 2),
    }

    # 6. report
    replaces = {
        "lut_matmul": "src/repro/kernels/lut_matmul.py:30",
        "seqmul_matmul": "src/repro/kernels/seqmul_matmul.py:53",
        "packed_matmul": "src/repro/kernels/packed_matmul.py:64",
    }
    table = []
    for name in ("lut_matmul", "seqmul_matmul", "packed_matmul"):
        mine = [r for r in rows if r["name"] == name]
        main_row = next(r for r in mine if tuple(r["shape"]) == MAIN_SHAPE and r["n"] == 8)
        table.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": runs[name]["counts"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shape": main_row["shape"],
            "launches_per_prefill": runs[name]["per_prefill"][name],
            "launches_per_decode_step": runs[name]["per_decode"][name],
        })
    print("kernels: " + json.dumps([[k["name"], k["launches"]] for k in table]), flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
