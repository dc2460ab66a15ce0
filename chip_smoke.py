#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py    # everything below, on one card

Phases, one line each (or a few):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, compute capability (must be 9.0), TF32 off;
2. build: every kernel of ``src/repro_torch/kernels/csrc`` with one nvcc
   per source, all started together;
3. kernels: each kernel's wrapper against its plain PyTorch version on
   the card at the main path's shapes.  GEMMs: M in {decode batch,
   admission prompt, batch x prompt}, (K, N) the projections of
   qwen3-0.6b, plus a sweep over (n, t), and lut_matmul at the train
   shape (M = 1024, both MLP projections); the integer GEMMs must be
   bit-equal, lowrank_matmul within 2e-6 * max|want|, and every GEMM must
   give the same bits on two launches; lut_matmul's and seqmul_matmul's
   ``launch_plan`` must equal the launch the built library makes.  Then
   their edge cases: packed lanes at +-(2^n - 1) at n = 8 and 15 with K =
   3072, an odd K, M = 1 and (33, 300, 70); lowrank with every magnitude
   255 and mixed signs, with zero SVD tables (then bit-equal), M = 1,
   (33, 300, 70) and rank 24; lut and seqmul with every magnitude 2^n - 1
   and mixed signs, M = 1, (33, 301, 70), n = 1 and int64 sums.  Attention: the
   serve shapes of qwen3-0.6b (16 query and 8 KV heads of 128, bf16;
   prefill q (4, 32) over a 48-slot cache with a masked tail, key block
   16; decode batch 4 over 48 slots), a window + softcap case each, and
   one long shape each, and flash_attention and approx_attention_bitexact
   at the train shape (B 8, S = T = 128, key block 64 for the latter, with
   lse, as the train step's forward runs them), and flash_attention at the
   speculative verify shape (q (4, 5) over the 52-slot pool cache, per-row
   starts, stale slots past each window, a dead lane parked in the spare
   tail); flash_attention (o, and
   lse at the train shape) and flash_decode within rtol = atol = 2e-5
   of the plain version (max|err| / limit printed),
   approx_attention within one probability
   quantum (max|v| / 255) and 1e-5 for 99% of the outputs, with the
   bit-equal share printed; every attention row bit-identical over two
   launches and with ``launch_plan`` equal to the launch the built
   library makes; one more launch counts on the card the work the kernel
   skips, which must equal the masked-block rule's count (the (work item,
   key tile) pairs of ``fwd_tile_plan`` or ``approx_tile_plan``, the
   cache chunks of ``decode_chunk_plan``), and the count goes into the
   kernels line; every flash_attention and flash_decode row also prints
   its ``device_ms`` and SDPA's (``library_device_ms``); the build phase
   checks that every forward instantiation of flash_attention and every
   lowrank instantiation of approx_attention has tensor-core instructions
   (HMMA, IMMA) in its SASS and no decode or bitexact one has any.
   Backward: the dq and dk/dv kernels (bf16 tensor cores, float32
   operands split into two bf16 terms, tiles with nothing to add skipped)
   against ``flash_attention_bwd_plain`` on the forward kernel's (o, lse),
   float32, within 1e-4 * max|want| per output (max|err| / limit printed for
   each) and bit-identical over two launches, at the train shape (B 8, S =
   T = 128, bf16), at S = T = 1024, with window + softcap, and over the
   serve cache with masked slots and one left-padded row, each with
   ``launch_plan`` equal to the launch the built library makes, beside
   SDPA's backward by loop time and by device time (its forward and
   backward replayed from one CUDA graph, less its forward alone); the
   build phase checks that every instantiation of both kernels has
   tensor-core instructions (HMMA) in its SASS.  Elementwise multiplier:
   ``seqmul_packed`` at n in {4, 8, 12, 15} and ``seqmul_words`` at n in
   {8, 15, 16}, t in {1, n/2, n-1}, approx and fix_to_1 both ways, on
   every (a, b) pair (n <= 8, 12) or numpy draws (2^20 + 3 at n = 15, 2^24
   at n = 16), then sizes 1, 127, 129 and 2^20 + 3, a 0-d and an empty
   tensor, and unaligned views: all bit-equal.
   Timed rows print the kernel's time, the plain version's, the bound
   (the larger of the bytes at 3.35 TB/s and the operations at their
   rate: table lookups at the shared-memory rate, the least integer
   operations of the recurrence at the SMs' int32 issue rate, int8
   tensor-core products (4 per product of 9- to 16-bit operands), TF32
   tensor-core products (lowrank's correction, 3 per product), bf16
   tensor-core products (the flash forward and backward, as their splits
   run them), float32 FLOPs on the CUDA cores (the decode); for attention
   counted over the query-slot pairs and the K/V slots this run's
   positions need, masked pairs adding nothing; approx_attention_lowrank
   as int8 tensor-core products for its exact parts and split TF32 for
   its corrections, as lowrank_matmul) and one PyTorch
   call that computes the same function, a yardstick the port never calls
   (torch.matmul for packed_matmul and lowrank_matmul,
   scaled_dot_product_attention for flash_attention and flash_decode, its
   backward alone for the backward kernels; none exists for the
   approximate products of lut_matmul, seqmul_matmul, approx_attention
   and the elementwise pair, and the exact torch.matmul beside the first
   two is printed as a yardstick only).  Times are per call over a loop
   of calls (the host's launch included); every GEMM row also prints
   ``device_ms``, the device's time alone (calls replayed from one CUDA
   graph), packed_matmul and lowrank_matmul with ``library_device_ms``
   beside it, lut_matmul with its time on magnitudes below 64 (no bank
   conflict in its gathers), and the backward pair, the flash rows and the
   timed approximate attention rows their ``device_ms``;
4. reference: ``engine.matmul`` on the card against the CPU reference
   bodies at a small shape (bit-equal; lowrank within 2e-6 * max|want|),
   and reduced qwen3-0.6b prefill logits on the card against the CPU
   (float32, rtol/atol 1e-4: sums run in another order): exact and
   bitexact, each with ``attn_impl`` "xla" and "pallas" (bitexact under
   pallas with the attention contractions approximated too); one train
   step's loss and gradients of reduced qwen3-0.6b (bitexact on mlp and
   attn, pallas) on the card against the CPU (rtol 1e-5; 1e-4 * max|want|);
5. serve: the continuous scheduler on full-width qwen3-0.6b (28 layers,
   d_model 1024, vocab 151936, bf16, weights from a seed) at tier
   ``exact`` (no kernel: the yardstick), tier ``balanced`` (lut_matmul),
   tier ``draft`` (packed_matmul) and ``--approx-mode seqmul``
   (seqmul_matmul); then with ``attn_impl="pallas"`` at tier ``exact``
   (flash_attention, flash_decode), tier ``balanced`` (adds
   approx_attention_bitexact and lut_matmul) and ``lowrank`` on mlp and
   attn (lowrank_matmul, approx_attention_lowrank, flash_decode); four
   batches of requests per run (two for seqmul).  Every launch count is
   set to 0 just before each run and read just after.
   After each run, one pool prefill and one decode step give the
   launches and host time per step, and a profiler pass over three
   decode steps the device's busy share.  Then the rest of serving:
   ``SelfSpeculative(k=4, draft_tier="draft")`` on the exact pool over the
   exact run's 16 requests (packed_matmul) and on the pallas exact pool
   over 8 of its requests (flash_decode, flash_attention, packed_matmul),
   their streams held against the greedy runs' by the margin rule (equal
   up to each request's first greedy step whose top-2 logit gap, by
   teacher forcing, is under ``STREAM_MARGIN``), with accept rate, rounds,
   modeled cost, tok/s and launches per round; the open loop on the
   ``bursty`` preset (32 requests, virtual clock, ``SLOAdaptive`` on its
   default ladder: lut_matmul, packed_matmul), whose switch sequence and
   per-request queue delays must equal those of reduced qwen3-0.6b on the
   CPU in the same call; the static loop at exact on 16 prompts of the
   bucket's length, held against the continuous scheduler by the margin
   rule; and ``run_soak`` on the ``steady`` preset (64 requests, windows of
   32, two parity spot-checks), which must keep every invariant;
6. train: ``make_train_step`` through ``run_loop`` at full width (seed-0
   weights, ``SyntheticLM`` data, batch 8 x seq 128, 16 steps, the
   reference driver's schedule) for ``paper-multiplier`` with
   ``attn_impl="pallas"`` (lut_matmul on the MLPs, flash_attention with
   lse, the dq and dk/dv kernels) and qwen3-0.6b bitexact on mlp and attn
   with ``attn_impl="pallas"`` (adds approx_attention_bitexact): the loss
   must be finite and fall; each prints the means of its first and last
   ten losses, its first two losses, step ms, train tokens/s, launches
   per step and the busy share of one profiled step.  Then the train CLI
   on paper-multiplier, 8 steps with a checkpoint every 4 and a failure
   injected at step 5, which it must recover from, with the losses of its
   first and last steps (its "loss a -> b" averages ten steps at each end,
   the same steps over a run of 8);
7. error analysis: ``engine.multiply`` (auto) and
   ``kernels.ops.approx_multiply`` on CUDA tensors (``seqmul_packed``, its
   launch count seen to rise), ``exhaustive_eval(12, 6)`` with fix_to_1
   both ways and ``mc_eval(16, 8)`` at 2^24 samples (their products from
   ``seqmul_words``) and ``mc_eval(32, 16)`` at 2^22 (``core.seqmul`` on
   the card), each with its wall time and the device's busy share, printed
   as a JSON line of its own; the launch counts are those of these calls.
   Then the checks: ``exhaustive_eval(12, 6)`` equal field for field to
   the CPU's (without fix_to_1 its worst overshoot is the closed-form
   MAE), so are ``exhaustive_eval`` at n = 1 and 4 and both ``mc_eval`` at
   2^16 samples; ``seqmul_words``' low + (high << 16) equal to
   ``core.seqmul``'s products on mc_eval(16, 8)'s draws; then ``python -m
   repro_torch.examples.quickstart`` and ``accuracy_sweep --steps 80`` on
   the card, which must exit 0;
8. the kernel table as JSON, then ``{"ok": true, "device": {...}}`` as the
   last line.

Any failed check exits non-zero before the last line is printed; so does
a machine without CUDA, or a directory without the repository's ``src``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
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
TF32_TENSOR_FLOPS_PER_S = 495e12  # H100 SXM dense TF32 tensor cores (NVIDIA data sheet)
BF16_TENSOR_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
F32_LANES_PER_CLK_PER_SM = 128  # Hopper SM: 4 partitions x 32 FP32 lanes, one FMA each

# qwen3-0.6b projections (K, N): q, k/v, o, mlp up/gate, mlp down
PROJECTIONS = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]
SERVE = dict(requests=16, batch=4, prompt=32, gen=16)  # four batches per run
MAIN_SHAPE = (SERVE["batch"] * SERVE["prompt"], 1024, 3072)  # reported in the JSON
# qwen3-0.6b attention: query heads, KV heads, head width; the serve cache length
HEADS, KV_HEADS, HEAD_DIM = 16, 8, 128
CACHE = SERVE["prompt"] + SERVE["gen"]
# self-speculative serving: proposals per round; a verify forward is (B, k+1)
# over the pool cache, which holds k spare slots per row
SPEC_K = 4
VERIFY_CACHE = CACHE + SPEC_K
# the open-loop run's TTFT target (ms), at which the bursty trace makes the
# SLO-adaptive policy switch tiers (found on the CPU: the virtual clock's
# schedule does not depend on the model)
OPEN_SLO_TTFT_MS = 50.0
# A greedy choice whose top-2 logit gap is under this many logits may go
# either way between two programs that differ only in rounding: the logits
# are float32 from a bf16 hidden state, whose rounding moves a logit by
# about 1e-2 at full width.  Two streams must agree up to a request's first
# step with a gap under it (gaps by teacher forcing the greedy stream)
STREAM_MARGIN = 0.1
GEMM_KERNELS = ("lut_matmul", "seqmul_matmul", "packed_matmul", "lowrank_matmul")
ATTN_KERNELS = ("flash_attention", "flash_decode", "approx_attention_bitexact",
                "approx_attention_lowrank")
BWD_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
ELEMENTWISE_KERNELS = ("seqmul_packed", "seqmul_words")
# the elementwise kernels' main rows: every (a, b) pair at n = 12 (packed)
# and as many numpy draws at the paper's n = 16 (words), 2^24 elements each
ELEMENTWISE_MAIN = {"seqmul_packed": (12, 6), "seqmul_words": (16, 8)}
ELEMENTWISE_RAGGED = [(), (0,), (1,), (127,), (129,), ((1 << 20) + 3,)]
# the train runs: the reference driver's batch and sequence defaults
TRAIN = dict(batch=8, seq=128, steps=16)
REPLACES = {
    "lut_matmul": "src/repro/kernels/lut_matmul.py:30",
    "seqmul_matmul": "src/repro/kernels/seqmul_matmul.py:53",
    "packed_matmul": "src/repro/kernels/packed_matmul.py:64",
    "lowrank_matmul": "src/repro/kernels/lowrank_matmul.py:33",
    "flash_attention": "src/repro/kernels/flash_attention.py:57",
    "flash_decode": "src/repro/kernels/flash_attention.py:296",
    "approx_attention_bitexact": "src/repro/kernels/approx_attention.py:184",
    "approx_attention_lowrank": "src/repro/kernels/approx_attention.py:171",
    "flash_attention_bwd_dq": "src/repro/kernels/flash_attention.py:126",
    "flash_attention_bwd_dkv": "src/repro/kernels/flash_attention.py:158",
    "seqmul_packed": "src/repro/kernels/seqmul_kernel.py:33",
    "seqmul_words": "src/repro/kernels/seqmul_kernel.py:54",
}
SOURCES = {
    "flash_decode": "flash_attention",
    "approx_attention_bitexact": "approx_attention",
    "approx_attention_lowrank": "approx_attention",
    "flash_attention_bwd_dq": "flash_attention_bwd",
    "flash_attention_bwd_dkv": "flash_attention_bwd",
    "seqmul_packed": "seqmul_kernel",
    "seqmul_words": "seqmul_kernel",
}


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


def tensor_core_instructions(source: str, names: tuple, without: tuple = ()) -> dict:
    """``{kernel: [count per instantiation]}`` of tensor-core MMA
    instructions (HMMA for float and mma.sync, HGMMA for wgmma, IMMA for
    integer mma.sync) in the SASS of a built library (``cuobjdump
    -sass``), for the kernels whose names contain one of ``names`` or
    ``without``; each instantiation of ``names`` must have some, none of
    ``without`` any."""
    from repro_torch.kernels import build

    tool = pathlib.Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(source))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            name = next((n for n in names + without if n in mangled), None)
            current = None if name is None else counts.setdefault(name, [])
            if current is not None:
                current.append(0)
        elif current is not None and any(op in line for op in ("HMMA", "HGMMA", "IMMA")):
            current[-1] += 1
    check(all(counts.get(n) and all(counts[n]) for n in names),
          f"{source}: a kernel without tensor-core instructions: {counts}")
    check(all(counts.get(n) and not any(counts[n]) for n in without),
          f"{source}: tensor-core instructions where none belong: {counts}")
    return counts


# --------------------------------------------------------------- timing
def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's time per call (Python, the launch) drops out."""
    import torch

    fn()  # warm: builds, caches, the split-K counters
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, reps=5) / reps


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
        self.f32_flops_per_s = 2 * F32_LANES_PER_CLK_PER_SM * self.sms * self.clock_hz

    def bound(self, nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
        return self.bound_s(nbytes, ops / ops_per_s)

    def bound_s(self, nbytes: float, ops_s: float) -> tuple[float, str]:
        """The larger of the bytes' time and ``ops_s``, the operations' time."""
        t_bytes = nbytes / HBM_BYTES_PER_S
        return (max(t_bytes, ops_s) * 1e3, "bytes" if t_bytes >= ops_s else "operations")


def one_word_ops_per_product(n: int) -> int:
    """The least int32 operations one product of the elementwise kernels'
    one-word recurrence needs (``csrc/seqmul_kernel.cu``), one Hopper
    instruction each: 8 per cycle and 7 per product."""
    return 8 * n + 7


def seqmul_ops(m: int, k: int, n_cols: int, n: int) -> int:
    """The int32 issue slots the bit-sliced recurrence needs for an (m, k)
    x (k, n_cols) call, the count set out in the note of
    ``csrc/seqmul_matmul.cu``: 3n^2 + 19n + 4 per output and K word of 32
    lanes (POPC, at a quarter of the rate of LOP3 and IADD3 on sm_90,
    counted as 4), and 2 (n + 2) per operand element to build its planes.
    Every product runs all n cycles, whatever its operands."""
    words = -(-k // 32)
    return m * n_cols * words * (3 * n * n + 19 * n + 4) + (m * k + k * n_cols) * 2 * (n + 2)


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
    for k, n in ((1024, 3072), (3072, 1024)):  # the MLP projections at the train shape
        cases.append(("lut_matmul", TRAIN["batch"] * TRAIN["seq"], k, n, 8, 4))
    for m in (SERVE["batch"], SERVE["batch"] * SERVE["prompt"]):
        cases.append(("seqmul_matmul", m, 1024, 3072, 12, 6))
        cases.append(("seqmul_matmul", m, 3072, 1024, 12, 5))
    cases.append(("packed_matmul", SERVE["batch"], 3072, 1024, 15, 1))
    cases.append(("packed_matmul", SERVE["batch"] * SERVE["prompt"], 1024, 3072, 12, 1))
    for m in ms:
        for k, n in PROJECTIONS:
            cases.append(("lowrank_matmul", m, k, n, 8, 4))
    return cases


def run_kernel_case(card: Card, name, m, k, n, bits, t, seed, timed: bool):
    import torch

    from repro_torch.engine import artifacts
    from repro_torch.kernels import lowrank_matmul as lr
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import seqmul_matmul as sm

    _, _, mx, sx, mw, sw, scale = operands(m, k, n, bits, seed)
    library = plan = None
    extra = {}
    if name == "lowrank_matmul":
        u, v, _ = artifacts.svd_factors(bits, t, 8, True, mx.device)
        a, b = mx.to(torch.uint8), mw.to(torch.uint8)
        kern = lambda: lr.lowrank_matmul(u, v, a, sx, b, sw, n=bits)
        plain = lambda: lr.lowrank_matmul_plain(u, v, a, sx, b, sw, n=bits)
        rank = u.shape[1]
        nbytes = 2 * u.numel() * 4 + 2 * m * k + 2 * k * n + 4 * m * n
        # the least time of the kernel's design: the integer part on the int8
        # tensor cores (9-bit signed operands: 4 int8 products of 2 ops each),
        # the correction as 3 TF32 products on the tensor cores (split TF32)
        ops_s = (8 * m * k * n / INT8_TENSOR_OPS_PER_S
                 + 3 * 2 * m * k * n * rank / TF32_TENSOR_FLOPS_PER_S)
        bound = card.bound_s(nbytes, ops_s)
        # one torch.matmul of [A | Ue'] @ [B ; Ve'], concatenated outside the timing
        sxf, swf = sx.to(torch.float32), sw.to(torch.float32)
        lhs = torch.cat([mx.to(torch.float32) * sxf,
                         (u[mx.long()] * sxf[..., None]).reshape(m, k * rank)], dim=1)
        rhs = torch.cat([mw.to(torch.float32) * swf,
                         (v[mw.long()] * swf[..., None]).permute(0, 2, 1).reshape(k * rank, n)])
        library = lambda: torch.matmul(lhs, rhs)
    elif name == "lut_matmul":
        lut = artifacts.product_lut_u16(bits, t, True, mx.device)
        a, b = mx.to(torch.uint8), mw.to(torch.uint8)
        kern = lambda: lm.lut_matmul(lut, a, sx, b, sw, n=bits)
        plain = lambda: lm.lut_matmul_plain(lut, a, sx, b, sw, n=bits)
        plan = lm.launch_plan(m, k, n, bits, card.sms)
        built = lm.built_launch_plan(plan, m, k, n, bits, card.sms)
        # the bytes the function must move: operands, output and table once
        nbytes = lut.numel() * 2 + 2 * m * k + 2 * k * n + 4 * m * n
        bound = card.bound(nbytes, m * k * n, card.lookups_per_s)
        # the design's copies of the table, one per block of the persistent
        # grid, read from L2 into shared memory: reported, not in the bound
        extra = dict(table_copy_bytes=lut.numel() * 2 * plan.grid[0])
    elif name == "seqmul_matmul":
        a, b = mx.to(torch.int16), mw.to(torch.int16)
        kern = lambda: sm.seqmul_matmul(a, sx, b, sw, n=bits, t=t)
        plain = lambda: sm.seqmul_matmul_plain(a, sx, b, sw, n=bits, t=t)
        plan = sm.launch_plan(m, k, n, bits, card.sms)
        built = sm.built_launch_plan(plan, m, k, n, bits, t)
        nbytes = 3 * m * k + 3 * k * n + 4 * m * n
        bound = card.bound(nbytes, seqmul_ops(m, k, n, bits), card.int32_ops_per_s)
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
    again = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    where = f"{name} M={m} K={k} N={n} n={bits} t={t}"
    check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
          f"{where}: two launches on the same inputs differ")
    if name == "lowrank_matmul":
        # the float32 correction is summed in another order
        limit = 2e-6 * want.abs().max().item()
        check(err <= limit, f"{where}: kernel vs plain max |err| {err} over {limit}")
    else:
        check(torch.equal(got, want), f"{where}: kernel != plain (max |err| {err})")
    row = dict(name=name, shape=[m, k, n], n=bits, t=t, max_abs_err=err,
               bound_ms=bound[0], bound_by=bound[1], **extra)
    if plan is not None:
        # the Python plan the wrapper launches with against the built library's
        check((plan.grid, plan.threads, plan.smem) == built,
              f"{where}: launch_plan {plan} but the library launches {built}")
        row["plan"] = dict(grid=list(plan.grid), threads=plan.threads, smem=plan.smem,
                           splits=plan.splits, k_chunk=plan.k_chunk)
    if timed:
        # the dequantized operands (the joint scale folded into the left one)
        xq, wq = (mx * sx).to(torch.float32) * scale, (mw * sw).to(torch.float32)
        row["ms"] = cuda_ms(kern, reps=20, warmup=2)
        row["plain_ms"] = cuda_ms(plain, reps=2)
        if name in ("lut_matmul", "seqmul_matmul"):
            # no PyTorch call computes the approximate products; the exact
            # GEMM on the same operands is kept as a yardstick, not a library time
            row["library_ms"] = None
            row["exact_matmul_ms"] = cuda_ms(lambda: torch.matmul(xq, wq), reps=20, warmup=2)
        else:
            if library is None:
                library = lambda: torch.matmul(xq, wq)
            row["library_ms"] = cuda_ms(library, reps=20, warmup=2)
        # the device's time alone, kernel and library call alike
        row["device_ms"] = graph_ms(kern)
        if library is not None:
            row["library_device_ms"] = graph_ms(library)
        if name == "lut_matmul":
            # the same call with every magnitude below 64, where no two lanes
            # of a warp's gather share a bank (csrc/lut_matmul.cu): the rest of
            # device_ms over this is what the bank conflicts cost
            a64, b64 = a & 63, b & 63
            row["device_ms_mag_below_64"] = graph_ms(
                lambda: lm.lut_matmul(lut, a64, sx, b64, sw, n=bits))
    return row


def phase_kernels(card: Card) -> list:
    rows = []
    for i, (name, m, k, n, bits, t) in enumerate(kernel_cases()):
        # the main path's (n, t), and seqmul's int64 sums at n = 12
        timed = (bits, t) == (8, 4) or (name == "seqmul_matmul" and bits == 12)
        row = run_kernel_case(card, name, m, k, n, bits, t, seed=100 + i, timed=timed)
        rows.append(row)
        times = (
            f" ms {row['ms']:.4f} plain_ms {row['plain_ms']:.3f} library_ms "
            + (f"{row['library_ms']:.4f}" if row["library_ms"] is not None else
               f"none (exact matmul {row['exact_matmul_ms']:.4f})") if "ms" in row else ""
        )
        if row.get("library_ms"):
            times += f" ratio {row['ms'] / row['library_ms']:.3f}"
        if "library_device_ms" in row:
            times += (f" device_ms {row['device_ms']:.4f} library_device_ms "
                      f"{row['library_device_ms']:.4f} device ratio "
                      f"{row['device_ms'] / row['library_device_ms']:.3f}")
        elif "device_ms" in row:
            times += f" device_ms {row['device_ms']:.4f}"
        if "device_ms_mag_below_64" in row:
            times += f" (magnitudes below 64: {row['device_ms_mag_below_64']:.4f})"
        if "plan" in row:
            times += f" plan {row['plan']} as built"
        if "table_copy_bytes" in row:
            times += f" table copies (L2 to shared memory) {row['table_copy_bytes']} bytes"
        agree = "bit-equal" if row["max_abs_err"] == 0 else f"max |err| {row['max_abs_err']:.3e}"
        print(f"kernel {name} M={m} K={k} N={n} n={bits} t={t}: {agree}{times} "
              f"bound_ms {row['bound_ms']:.5f} ({row['bound_by']})", flush=True)
    return rows + phase_gemm_edges()


# (kernel, kind, M, K, N, n): the tensor-core GEMMs at their edges
GEMM_EDGES = [
    ("packed_matmul", "extreme mixed", 4, 3072, 1024, 8),
    ("packed_matmul", "extreme alike", 4, 3072, 1024, 8),
    ("packed_matmul", "extreme mixed", 128, 3072, 1024, 15),
    ("packed_matmul", "extreme alike", 4, 3072, 1024, 15),
    ("packed_matmul", "random", 4, 301, 64, 12),  # odd K: a zero pad lane
    ("packed_matmul", "random", 1, 1024, 3072, 8),
    ("packed_matmul", "random", 33, 300, 70, 15),
    ("lowrank_matmul", "mag 255", 4, 1024, 3072, 8),
    ("lowrank_matmul", "mag 255", 128, 1024, 3072, 8),
    ("lowrank_matmul", "zero tables", 4, 3072, 1024, 8),
    ("lowrank_matmul", "zero tables", 33, 300, 70, 8),
    ("lowrank_matmul", "random", 1, 1024, 3072, 8),
    ("lowrank_matmul", "random", 33, 300, 70, 8),
    ("lowrank_matmul", "rank 24", 33, 300, 70, 8),  # three blocks of 8 r per K step
    ("lut_matmul", "mag max", 4, 3072, 1024, 8),
    ("lut_matmul", "mag max", 1024, 1024, 3072, 8),
    ("lut_matmul", "random", 1, 1024, 3072, 8),
    ("lut_matmul", "random", 33, 301, 70, 8),  # ragged: byte loads, one split tile
    ("lut_matmul", "random", 2, 33000, 64, 8),  # int64 sums
    ("lut_matmul", "random", 33, 301, 70, 1),
    ("seqmul_matmul", "mag max", 4, 3072, 1024, 12),  # int64 sums
    ("seqmul_matmul", "mag max", 128, 1024, 3072, 8),
    ("seqmul_matmul", "random", 1, 1024, 3072, 8),
    ("seqmul_matmul", "random", 33, 301, 70, 8),
    ("seqmul_matmul", "random", 33, 301, 70, 1),
]


def phase_gemm_edges() -> list:
    """The split-K GEMMs at their edges, untimed: packed lanes at
    +-(2^n - 1) with mixed or like signs (every int8 plane pair at its
    extreme; int32 sums at n = 8, int64 at n = 15), an odd K, M = 1 and
    a ragged shape; lowrank with every magnitude 255 and mixed signs, and
    with zero SVD tables, where it must be bit-equal (the exact part
    alone); lut and seqmul with every magnitude 2^n - 1 and mixed signs,
    M = 1, a ragged shape, n = 1, and int64 sums (lut at K = 33000, seqmul
    at n = 12).  Each also launched twice: the same bits both times."""
    import numpy as np
    import torch

    from repro_torch.engine import artifacts
    from repro_torch.kernels import lowrank_matmul as lr
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import seqmul_matmul as sm

    rows = []
    for i, (name, kind, m, k, n_cols, bits) in enumerate(GEMM_EDGES):
        rng = np.random.default_rng(900 + i)
        qmax = (1 << bits) - 1
        if name == "packed_matmul":
            if kind == "extreme mixed":
                a, b = rng.choice([-qmax, qmax], (m, k)), rng.choice([-qmax, qmax], (k, n_cols))
            elif kind == "extreme alike":
                a, b = np.full((m, k), qmax), np.full((k, n_cols), -qmax)
            else:
                a, b = rng.integers(-qmax, qmax + 1, (m, k)), rng.integers(-qmax, qmax + 1, (k, n_cols))
            pa = pm.pack_i16_pairs(torch.from_numpy(a).cuda(), dim=1)
            pb = pm.pack_i16_pairs(torch.from_numpy(b).cuda(), dim=0)
            kern = lambda: pm.packed_matmul(pa, pb, n=bits)
            plain = lambda: pm.packed_matmul_plain(pa, pb)
        elif name in ("lut_matmul", "seqmul_matmul"):
            mag_a, mag_b = rng.integers(0, qmax + 1, (m, k)), rng.integers(0, qmax + 1, (k, n_cols))
            if kind == "mag max":
                mag_a, mag_b = np.full_like(mag_a, qmax), np.full_like(mag_b, qmax)
            dtype = torch.uint8 if name == "lut_matmul" else torch.int16
            args = (torch.from_numpy(mag_a).to("cuda", dtype),
                    torch.from_numpy(rng.choice([-1, 0, 1], (m, k), p=[0.45, 0.1, 0.45]))
                    .to("cuda", torch.int8),
                    torch.from_numpy(mag_b).to("cuda", dtype),
                    torch.from_numpy(rng.choice([-1, 0, 1], (k, n_cols), p=[0.45, 0.1, 0.45]))
                    .to("cuda", torch.int8))
            t = max(1, bits // 2)
            if name == "lut_matmul":
                args = (artifacts.product_lut_u16(bits, t, True, torch.device("cuda")), *args)
                kern = lambda: lm.lut_matmul(*args, n=bits)
                plain = lambda: lm.lut_matmul_plain(*args, n=bits)
            else:
                kern = lambda: sm.seqmul_matmul(*args, n=bits, t=t)
                plain = lambda: sm.seqmul_matmul_plain(*args, n=bits, t=t)
        else:
            mag_a, mag_b = rng.integers(0, qmax + 1, (m, k)), rng.integers(0, qmax + 1, (k, n_cols))
            if kind == "mag 255":
                mag_a, mag_b = np.full_like(mag_a, qmax), np.full_like(mag_b, qmax)
            sign_a = rng.choice([-1, 0, 1], (m, k), p=[0.45, 0.1, 0.45])
            sign_b = rng.choice([-1, 1], (k, n_cols))
            rank = 24 if kind == "rank 24" else 8
            u, v, _ = artifacts.svd_factors(bits, 4, rank, True, torch.device("cuda"))
            if kind == "zero tables":
                u, v = torch.zeros_like(u), torch.zeros_like(v)
            args = (u, v, torch.from_numpy(mag_a).to("cuda", torch.uint8),
                    torch.from_numpy(sign_a).to("cuda", torch.int8),
                    torch.from_numpy(mag_b).to("cuda", torch.uint8),
                    torch.from_numpy(sign_b).to("cuda", torch.int8))
            kern = lambda: lr.lowrank_matmul(*args, n=bits)
            plain = lambda: lr.lowrank_matmul_plain(*args, n=bits)
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        where = f"{name} {kind} M={m} K={k} N={n_cols} n={bits}"
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"{where}: two launches on the same inputs differ")
        err = (got - want).abs().max().item()
        if name == "lowrank_matmul" and kind != "zero tables":
            limit = 2e-6 * want.abs().max().item()
            check(err <= limit, f"{where}: kernel vs plain max |err| {err} over {limit}")
        else:
            check(torch.equal(got, want), f"{where}: kernel != plain (max |err| {err})")
        agree = "bit-equal" if err == 0 else f"max |err| {err:.3e} (max |want| {want.abs().max().item():.6g})"
        print(f"kernel {where}: {agree}, two launches bit-identical", flush=True)
        rows.append(dict(name=name, label=kind, shape=[m, k, n_cols], n=bits, t=None,
                         max_abs_err=err))
    return rows


# ----------------------------------------------------------- attention
def attention_cases():
    """(kernel, label, B, S, T, bk, window, softcap, timed): the serve shapes
    (prefill q (B, 32) over the 48-slot cache, decode over it), a window +
    softcap variant of each, one long shape each, and the forwards of train
    runs (a) and (b) at their shape, with lse: flash_attention and
    bitexact."""
    b, p = SERVE["batch"], SERVE["prompt"]
    cases = []
    for name in ATTN_KERNELS:
        s = 1 if name == "flash_decode" else p
        bk = {"flash_decode": None, "flash_attention": None}.get(name, 16)
        cases.append((name, "serve", b, s, CACHE, bk, None, None, True))
        cases.append((name, "window+softcap", b, s, CACHE, bk, 16, 30.0, False))
    cases.append(("flash_attention", "long", 1, 1024, 1024, None, None, None, True))
    cases.append(("flash_decode", "long", 4, 1, 4096, None, None, None, True))
    cases.append(("approx_attention_bitexact", "long", 1, 1024, 1024, 64, None, None, True))
    cases.append(("approx_attention_lowrank", "long", 1, 1024, 1024, 128, None, None, True))
    cases.append(("flash_attention", "train", TRAIN["batch"], TRAIN["seq"], TRAIN["seq"],
                  None, None, None, True))
    # the speculative verify forward under attn_impl="pallas": q (B, k+1) over the
    # whole pool cache, per-row starts, stale suffix slots, a dead lane parked
    cases.append(("flash_attention", "verify", b, SPEC_K + 1, VERIFY_CACHE, None, None, None,
                  False))
    cases.append(("approx_attention_bitexact", "train", TRAIN["batch"], TRAIN["seq"],
                  TRAIN["seq"], 64, None, None, True))
    return cases


def attention_inputs(b, s, t, seed, label=None):
    """bf16 q/k/v and positions.  Prefill over a cache (t > s): row 1 is
    left-padded by 5, every row's slots past its prompt are an unwritten
    (masked) tail.  Decode: row i has written t - 16 + 4i slots (32-44 of
    the 48 at the serve shape, a nearly full cache at the long one).
    Long prefill: no cache, positions 0..t-1.  Verify: ``verify_positions``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, HEADS, HEAD_DIM), generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, t, KV_HEADS, HEAD_DIM), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, t, KV_HEADS, HEAD_DIM), generator=g, device="cuda").to(torch.bfloat16)
    q_pos, k_pos = verify_positions(b, s, t) if label == "verify" else positions(b, s, t)
    return q, k, v, q_pos.to(torch.int32), k_pos.to(torch.int32)


def verify_positions(b, s, t):
    """A speculative verify window as ``models.attention`` masks it: row i,
    left-padded by ``pad[i]`` in the prompt bucket with ``emitted[i]``
    tokens out, writes slots ``w0 .. w0 + s - 1`` (``w0 = prompt + emitted -
    1``) at true positions from ``w0 - pad``; the slots past the window hold
    stale draft entries, masked.  The last row is a dead lane, parked at
    ``t - s`` with positions 0..s-1."""
    import torch

    p = SERVE["prompt"]
    pad = torch.tensor([0, 5, 2, 0][:b], device="cuda")
    emitted = torch.tensor([1, 6, 11, 0][:b], device="cuda")
    starts = p + emitted - 1
    starts[-1], pad[-1] = t - s, t - s  # the dead lane: offset = its start
    q_pos = (starts - pad)[:, None] + torch.arange(s, device="cuda")[None, :]
    jj = torch.arange(t, device="cuda").expand(b, t)
    last = (starts + s - 1)[:, None]
    k_pos = torch.where((jj >= pad[:, None]) & (jj <= last), jj - pad[:, None], -1)
    return q_pos, k_pos


def positions(b, s, t):
    import torch

    jj = torch.arange(t, device="cuda").expand(b, t)
    if s == t:
        return jj[:, :s].clone(), jj.clone()
    if s == 1:
        written = t - 16 + 4 * torch.arange(b, device="cuda")[:, None]
        return written[:, 0] - 1, torch.where(jj < written, jj, -1)
    pad = torch.zeros((b, 1), dtype=torch.int64, device="cuda")
    pad[1] = 5
    q_pos = torch.arange(s, device="cuda").expand(b, s) - pad
    return q_pos, torch.where((jj >= pad) & (jj < s), jj - pad, -1)


def run_attention_case(card: Card, case, seed):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import approx_attention as aa
    from repro_torch.kernels import flash_attention as fa

    name, label, b, s, t, bk, window, softcap, timed = case
    q, k, v, q_pos, k_pos = attention_inputs(b, s, t, seed, label)
    scale = HEAD_DIM**-0.5
    hd, h, kv = HEAD_DIM, HEADS, KV_HEADS
    # The work this run's data needs: a query row reads the slots it may
    # attend (a masked slot adds exactly 0); a row with none, a left pad,
    # averages every slot.  pairs: (query head, slot) pairs; slots: the
    # (row, slot) pairs whose K and V some query reads.
    allow = fa.allow_mask(q_pos.reshape(b, s), k_pos, causal=True, window=window)
    needed = allow | ~allow.any(-1, keepdim=True)
    pairs = h * needed.sum().item()
    slots = needed.any(1).sum().item()
    # per needed slot, K and V of every KV head: bf16, or a magnitude and a
    # sign byte each for bitexact (2 bytes per element either way)
    kv_bytes = 2 * 2 * kv * hd * slots
    # positions read once, the f32 output written once
    io_bytes = 4 * (q_pos.numel() + k_pos.numel()) + 4 * q.numel()
    # the train rows return lse too (written once), as the train step's forward does
    with_lse = label == "train"
    lse_bytes = 4 * b * h * s if with_lse else 0
    library = None
    if name == "flash_decode":
        kw = dict(window=window, softcap=softcap, scale=scale)
        kern = lambda: fa.flash_decode(q[:, 0], k, v, q_pos, k_pos, **kw)
        plain = lambda: fa.flash_decode_plain(q[:, 0], k, v, q_pos, k_pos, **kw)
        # bytes-bound: float32 FMAs on the CUDA cores, QK and PV (4 hd FLOPs a pair)
        bound = card.bound(2 * q.numel() + kv_bytes + io_bytes, 4 * pairs * hd,
                           card.f32_flops_per_s)
    elif name == "flash_attention":
        kw = dict(causal=True, window=window, softcap=softcap, scale=scale)
        if with_lse:
            # the train step's forward: (o, lse) against the plain version's
            kern = lambda: fa.flash_attention_fwd(q, k, v, q_pos, k_pos, with_lse=True, **kw)
            plain = lambda: fa.attend(q, k, v, q_pos, k_pos, with_lse=True, **kw)
        else:
            kern = lambda: fa.flash_attention(q, k, v, q_pos, k_pos, **kw)
            plain = lambda: fa.flash_attention_plain(q, k, v, q_pos, k_pos, **kw)
        # the products the kernel runs on the bf16 tensor cores: QK^T on bf16 q
        # and k (2 hd FLOPs a pair) and P.V with p as two bf16 terms (4 hd)
        bound = card.bound(2 * q.numel() + kv_bytes + io_bytes + lse_bytes, 6 * pairs * hd,
                           BF16_TENSOR_FLOPS_PER_S)
    else:
        mode, rank = name.rsplit("_", 1)[1], 8
        kw = dict(mode=mode, n=8, t=4, rank=rank, causal=True, window=window, softcap=softcap,
                  scale=scale, bk=bk)
        wrapper = lambda: aa.approx_flash_attention(q, k, v, q_pos, k_pos, **kw)
        plain = lambda: aa.approx_attention_plain(q, k, v, q_pos, k_pos, with_lse=with_lse,
                                                  **kw)
        # the kernel alone, on operands quantized once outside the timing
        ops = aa.kernel_operands(q, k, v, mode=mode, n=8, t=4, fix_to_1=True, rank=rank)
        kern = lambda: aa.launch_kernel(ops, q_pos, k_pos, bk=bk, causal=True, window=window,
                                        softcap=softcap, scale=scale, with_lse=with_lse)
        plan = aa.launch_plan(mode, b, s, t, h, kv, hd, 8, rank, card.sms)
        built = aa.built_launch_plan(mode, b, s, t, h, kv, hd, 8, rank, card.sms)
        # magnitudes and signs of q and the needed k, v slots (a byte each)
        nbytes = 2 * q.numel() + kv_bytes + io_bytes + lse_bytes
        if mode == "bitexact":
            # and the uint16 table, once; two lookups per pair and d
            bound = card.bound(nbytes + 2 * 2**16, 2 * pairs * hd, card.lookups_per_s)
        else:
            # and U and V (2^n, r) float32, once.  Per pair, the exact
            # products of QK and AV (2 hd) on the int8 tensor cores (4
            # products of 2 ops each, as lowrank_matmul), their corrections
            # (2 hd r) as 3 TF32 products, and r lookups for U[p_int]
            ops_s = (16 * pairs * hd / INT8_TENSOR_OPS_PER_S
                     + 3 * 2 * 2 * pairs * hd * rank / TF32_TENSOR_FLOPS_PER_S
                     + pairs * rank / card.lookups_per_s)
            bound = card.bound_s(nbytes + 2 * 4 * 2**8 * rank, ops_s)
    if name in ("flash_attention", "flash_decode") and softcap is None:
        # the same q/k/v and boolean mask; SDPA takes heads before the sequence
        qt = (q[:, :1] if name == "flash_decode" else q).transpose(1, 2).contiguous()
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        mask = allow[:, None]
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                         scale=scale, enable_gqa=True)
    got = (wrapper if name.startswith("approx") else kern)()
    want = plain()
    torch.cuda.synchronize()
    where = f"{name} {label} B={b} S={s} T={t} bk={bk} window={window} softcap={softcap}"
    row = dict(name=name, label=label, shape=[b, s, t, h, kv, hd], bk=bk,
               bound_ms=bound[0], bound_by=bound[1])
    if name.startswith("approx"):
        first, again = kern(), kern()
        if with_lse:
            (first, lse), (again, lse2), (want, want_lse) = first, again, want
            check(torch.equal(lse.view(torch.int32), lse2.view(torch.int32)),
                  f"{where}: lse differs between two launches")
            row["lse_max_abs_err"] = (lse - want_lse).abs().max().item()
        check(torch.equal(first.view(torch.int32), got.view(torch.int32)),
              f"{where}: the kernel alone != the wrapper")
        check(torch.equal(first.view(torch.int32), again.view(torch.int32)),
              f"{where}: two launches on the same inputs differ")
        check(plan == built, f"{where}: launch_plan {plan} but the kernel launches {built}")
        row["plan"] = dict(grid=list(plan.grid), threads=plan.threads, smem=plan.smem,
                           rows=plan.rows, heads=plan.heads)
        # the (work item, key block) pairs the kernel skips, counted on the card
        # in one more launch, against the masked-block rule's count on the CPU
        # (approx_tile_plan's pairs, once per KV head and head chunk)
        live = aa.approx_tile_plan(q_pos, k_pos, bk=bk, rows=plan.rows, causal=True,
                                   window=window)
        per_tile = kv * -(-(h // kv) // plan.heads)
        planned, pairs_total = int((~live).sum()) * per_tile, live.numel() * per_tile
        counter = torch.zeros(1, dtype=torch.int32, device=q.device)
        counted = aa.launch_kernel(ops, q_pos, k_pos, bk=bk, causal=True, window=window,
                                   softcap=softcap, scale=scale, with_lse=with_lse,
                                   skipped=counter)
        counted = counted[0] if with_lse else counted
        check(torch.equal(first.view(torch.int32), counted.view(torch.int32)),
              f"{where}: the launch that counts skipped pairs differs")
        row["skipped_pairs"] = int(counter.item())
        check(row["skipped_pairs"] == planned,
              f"{where}: the kernel skipped {row['skipped_pairs']} (item, block) pairs, "
              f"approx_tile_plan {planned}")
    else:
        again = kern()
        if with_lse:
            (got, lse), (again, lse2), (want, want_lse) = got, again, want
            check(torch.equal(lse.view(torch.int32), lse2.view(torch.int32)),
                  f"{where}: lse differs between two launches")
            lse_diff = (lse - want_lse).abs()
            row["lse_max_abs_err"] = lse_diff.max().item()
            row["lse_err_over_limit"] = (lse_diff / (2e-5 + 2e-5 * want_lse.abs())).max().item()
            check(row["lse_err_over_limit"] <= 1,
                  f"{where}: lse max |err| {row['lse_max_abs_err']} over rtol/atol 2e-5")
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"{where}: two launches on the same inputs differ")
        decode = name == "flash_decode"
        plan_args = ("decode" if decode else "fwd", b, s, t, h, kv, hd, q.dtype)
        plan = fa.launch_plan(*plan_args, sms=card.sms)
        built = fa.built_launch_plan(*plan_args, sms=card.sms)
        check(plan == built, f"{where}: launch_plan {plan} but the kernel launches {built}")
        row["plan"] = dict(grid=list(plan.grid), threads=plan.threads, smem=plan.smem,
                           rows=plan.rows, heads=plan.heads, keys=plan.keys)
        # what the kernel skips, counted on the card in one more launch, against
        # the rule's count on the CPU: (item, key tile) pairs of fwd_tile_plan once
        # per KV head, or cache chunks of decode_chunk_plan once per KV head
        counter = torch.zeros(1, dtype=torch.int32, device=q.device)
        if decode:
            live = fa.decode_chunk_plan(q_pos, k_pos, chunk=plan.keys, window=window)
            counted = fa.launch_decode(q[:, 0], k, v, q_pos, k_pos, skipped=counter, **kw)
            key, what = "skipped_chunks", "(b, KV head, chunk) triples"
        else:
            live = fa.fwd_tile_plan(q_pos, k_pos, rows=plan.rows, keys=plan.keys, causal=True,
                                    window=window)
            counted, counted_lse = fa.launch_forward(q, k, v, q_pos, k_pos, with_lse=with_lse,
                                                     skipped=counter, **kw)
            if with_lse:
                check(torch.equal(lse.view(torch.int32), counted_lse.view(torch.int32)),
                      f"{where}: the launch that counts skipped work writes another lse")
            key, what = "skipped_pairs", "(item, key tile) pairs"
        per_tile = kv * -(-(h // kv) // plan.heads)
        planned, pairs_total = int((~live).sum()) * per_tile, live.numel() * per_tile
        check(torch.equal(got.view(torch.int32), counted.view(torch.int32)),
              f"{where}: the launch that counts skipped work differs")
        row[key] = int(counter.item())
        check(row[key] == planned, f"{where}: the kernel skipped {row[key]} {what}, the plan "
                                   f"{planned}")
    check(bool(torch.isfinite(got).all()), f"{where}: non-finite output")
    diff = (got - want).abs()
    err = row["max_abs_err"] = diff.max().item()
    if name.startswith("approx"):
        quantum = v.float().abs().max().item() / 255
        row["bit_equal_share"] = (diff == 0).float().mean().item()
        row["within_1e-5_share"] = (diff <= 1e-5).float().mean().item()
        check(err <= quantum and row["within_1e-5_share"] >= 0.99,
              f"{where}: max |err| {err} (quantum {quantum}), within 1e-5: "
              f"{row['within_1e-5_share']}")
        agree = (f"max |err| {err:.3e} (quantum {quantum:.3e}), bit-equal "
                 f"{row['bit_equal_share']:.4f}, within 1e-5 {row['within_1e-5_share']:.4f}"
                 + (f", lse max |err| {row['lse_max_abs_err']:.3e}" if with_lse else "")
                 + f"; two launches bit-identical, launch_plan as built {row['plan']}, "
                 f"(item, key block) pairs skipped on the card {row['skipped_pairs']} of "
                 f"{pairs_total}, approx_tile_plan's count {planned}")
    else:
        row["err_over_limit"] = (diff / (2e-5 + 2e-5 * want.abs())).max().item()
        check(row["err_over_limit"] <= 1, f"{where}: max |err| {err}")
        agree = (f"max |err| {err:.3e}, over the limit rtol/atol 2e-5: "
                 f"{row['err_over_limit']:.4f}"
                 + (f", lse max |err| {row['lse_max_abs_err']:.3e}, over the limit "
                    f"{row['lse_err_over_limit']:.4f}" if with_lse else "")
                 + f"; two launches bit-identical, launch_plan as built "
                 f"{row['plan']}, {what} skipped on the card {row[key]} of {pairs_total}, the "
                 f"plan's count {planned}")
        row["device_ms"] = graph_ms(kern)
        if library is not None:
            row["library_device_ms"] = graph_ms(library)
    if timed:
        reps = 20 if label == "serve" else 5
        row["ms"] = cuda_ms(kern, reps=reps, warmup=2)
        row["plain_ms"] = cuda_ms(plain, reps=2)
        row["library_ms"] = cuda_ms(library, reps=reps, warmup=2) if library else None
        if name.startswith("approx"):
            row["wrapper_ms"] = cuda_ms(wrapper, reps=reps, warmup=2)
            row["device_ms"] = graph_ms(kern)
    device = (f" device_ms {row['device_ms']:.4f}" if "device_ms" in row else "") + (
        f" library_device_ms {row['library_device_ms']:.4f}" if "library_device_ms" in row
        else "")
    times = (f" ms {row['ms']:.4f} plain_ms {row['plain_ms']:.3f} library_ms "
             + (f"{row['library_ms']:.4f}" if row["library_ms"] is not None else "none")
             + (f" wrapper_ms (with quantization) {row['wrapper_ms']:.4f}"
                if "wrapper_ms" in row else "") + device
             if timed else device)
    print(f"kernel {where}: {agree}{times} bound_ms {row['bound_ms']:.5f} ({row['bound_by']})",
          flush=True)
    return row


def phase_attention(card: Card) -> list:
    return [run_attention_case(card, case, seed=300 + i)
            for i, case in enumerate(attention_cases())]


# ------------------------------------------------------------ backward
def backward_cases():
    """(label, B, S, T, window, softcap): the train shape, one long shape, a
    window + softcap variant, and the serve shape's cache with masked slots
    and one left-padded row (its pad queries see no slot)."""
    b, s = TRAIN["batch"], TRAIN["seq"]
    return [("train", b, s, s, None, None),
            ("long", 1, 1024, 1024, None, None),
            ("window+softcap", b, s, s, 64, 30.0),
            ("masked+pad", SERVE["batch"], SERVE["prompt"], CACHE, None, None)]


def run_backward_case(card: Card, case, seed):
    """dq and dk/dv kernels against flash_attention_bwd_plain on the forward
    kernel's (o, lse), float32 before the cast; two launches must give the
    same bits."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    label, b, s, t, window, softcap = case
    q, k, v, q_pos, k_pos = attention_inputs(b, s, t, seed)
    do = torch.randn((b, s, HEADS, HEAD_DIM), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    hd, h, kv = HEAD_DIM, HEADS, KV_HEADS
    kw = dict(causal=True, window=window, softcap=softcap, scale=hd**-0.5)
    o, lse = fa.flash_attention_fwd(q, k, v, q_pos, k_pos, **kw, with_lse=True)
    dd = torch.einsum("bshd,bshd->bhs", do, o)
    dq_fn = lambda: fa.flash_attention_bwd_dq(q, k, v, q_pos, k_pos, do, lse, dd, **kw)
    dkv_fn = lambda: fa.flash_attention_bwd_dkv(q, k, v, q_pos, k_pos, do, lse, dd, **kw)
    plain = lambda: fa.flash_attention_bwd_plain(q, k, v, q_pos, k_pos, o, lse, do, **kw)
    got, again = (dq_fn(), *dkv_fn()), (dq_fn(), *dkv_fn())
    want = plain()
    torch.cuda.synchronize()
    where = f"backward {label} B={b} S={s} T={t} window={window} softcap={softcap}"
    for kernel in ("dq", "dkv"):
        plan = fa.launch_plan(kernel, b, s, t, h, kv, hd, q.dtype)
        built = fa.built_launch_plan(kernel, b, s, t, h, kv, hd, q.dtype)
        check(plan == built, f"{where}: launch_plan {plan} but the kernel launches {built}")
    errs, ratios = [], []
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        check(bool(torch.isfinite(a).all()), f"{where}: non-finite {name}")
        check(torch.equal(a, a2), f"{where}: {name} differs between two launches")
        err = (a - w).abs().max().item()
        limit = 1e-4 * w.abs().max().item()
        check(err <= limit, f"{where}: {name} max |err| {err} over {limit}")
        errs.append(err)
        ratios.append(err / limit)
    # The work this run's data needs, on the bf16 tensor cores as the kernels
    # split it (csrc/flash_attention_bwd.cu): per allowed (query head, slot)
    # pair, 2*hd FLOPs per product, 5 products in dq (q k^T; do v^T with do
    # as two bf16 terms; ds k, ds as two terms) and 8 in dk/dv (the same
    # 3 for s and dp; ds^T q, 2; p^T do, both split, 3); a query with no
    # allowed slot (a pad) adds p^T do at every slot to dv.  Bytes: q, k, v
    # (bf16), do, lse, dd read once; dq or dk and dv (float32) written once.
    allow = fa.allow_mask(q_pos, k_pos, causal=True, window=window)
    pairs = h * allow.sum().item()
    pad_pairs = h * t * (~allow.any(-1)).sum().item()
    inputs = 2 * (q.numel() + k.numel() + v.numel()) + 4 * (do.numel() + lse.numel() + dd.numel())
    inputs += 4 * (q_pos.numel() + k_pos.numel())
    bf16 = BF16_TENSOR_FLOPS_PER_S
    bounds = {
        "flash_attention_bwd_dq": card.bound(inputs + 4 * q.numel(), 2 * hd * 5 * pairs, bf16),
        "flash_attention_bwd_dkv": card.bound(inputs + 8 * k.numel(),
                                              2 * hd * (8 * pairs + 3 * pad_pairs), bf16),
    }
    total = card.bound(inputs + 4 * q.numel() + 8 * k.numel(),
                       2 * hd * (13 * pairs + 3 * pad_pairs), bf16)
    rows = []
    for name, err, ratio in (("flash_attention_bwd_dq", errs[0], ratios[0]),
                             ("flash_attention_bwd_dkv", max(errs[1:]), max(ratios[1:]))):
        rows.append(dict(name=name, label=label, shape=[b, s, t, h, kv, hd], max_abs_err=err,
                         err_over_limit=ratio, bound_ms=bounds[name][0],
                         bound_by=bounds[name][1]))
    reps = 5 if label == "long" else 20
    plain_ms = cuda_ms(plain, reps=2)
    library_ms = library_device_ms = None
    if softcap is None:  # SDPA has no softcap
        # the backward alone of SDPA on the same bf16 q/k/v and boolean mask,
        # its forward outside the timing; heads before the sequence
        leaves = [x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=allow[:, None],
                                             scale=kw["scale"], enable_gqa=True)
        g_out = do.transpose(1, 2).to(out.dtype)
        library_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g_out, retain_graph=True),
                             reps=reps, warmup=2)
        # its device time: forward and backward replayed from one CUDA graph,
        # less the forward alone (autograd runs a backward on its forward's
        # stream, so both are captured), on fresh leaves: the graph kept for
        # the loop above holds the old leaves' gradient nodes on the default
        # stream, which a capture may not wait on; warmed on a side stream
        fresh = [x.detach().requires_grad_() for x in leaves]
        fwd = lambda: F.scaled_dot_product_attention(*fresh, attn_mask=allow[:, None],
                                                     scale=kw["scale"], enable_gqa=True)
        fwd_bwd = lambda: torch.autograd.grad(fwd(), fresh, g_out)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fwd_bwd()
        torch.cuda.current_stream().wait_stream(side)
        library_device_ms = graph_ms(fwd_bwd) - graph_ms(fwd)
    for row, fn in zip(rows, (dq_fn, dkv_fn)):
        row.update(ms=cuda_ms(fn, reps=reps, warmup=2), device_ms=graph_ms(fn),
                   plain_ms=plain_ms, library_ms=library_ms,
                   library_device_ms=library_device_ms)
    pair_ms = rows[0]["ms"] + rows[1]["ms"]
    times = (f" dq ms {rows[0]['ms']:.4f} (device {rows[0]['device_ms']:.4f}) dkv ms "
             f"{rows[1]['ms']:.4f} (device {rows[1]['device_ms']:.4f}) plain_ms (whole "
             f"backward) {plain_ms:.3f} library_ms (SDPA backward) "
             + (f"{library_ms:.4f} pair/SDPA {pair_ms / library_ms:.3f} library_device_ms "
                f"{library_device_ms:.4f} pair/SDPA by device time "
                f"{(rows[0]['device_ms'] + rows[1]['device_ms']) / library_device_ms:.3f}"
                if library_ms is not None else "none"))
    print(f"kernel {where}: max |err| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}, "
          f"over the limit 1e-4 * max|want|: dq {ratios[0]:.4f} dk {ratios[1]:.4f} dv "
          f"{ratios[2]:.4f}; two launches bit-identical, launch_plan as built;{times} bound_ms dq "
          f"{rows[0]['bound_ms']:.5f} ({rows[0]['bound_by']}) dkv {rows[1]['bound_ms']:.5f} "
          f"({rows[1]['bound_by']}) whole backward {total[0]:.5f} ({total[1]})", flush=True)
    return rows


def phase_backward(card: Card) -> list:
    return [row for i, case in enumerate(backward_cases())
            for row in run_backward_case(card, case, seed=500 + i)]


# ---------------------------------------------------------- elementwise
def u32_operands(shape, n: int, seed: int):
    """uint32 operands in [0, 2^n) on the card: every (a, b) pair for a 1-d
    shape of 2^(2n) elements, else numpy draws from ``seed``."""
    import numpy as np
    import torch

    size = math.prod(shape)
    if len(shape) == 1 and size == 1 << (2 * n):
        v = np.arange(1 << n, dtype=np.uint32)
        a, b = np.repeat(v, 1 << n), np.tile(v, 1 << n)
    else:
        rng = np.random.default_rng(seed)
        a, b = (rng.integers(0, 1 << n, size, dtype=np.uint64).astype(np.uint32)
                for _ in range(2))
    return tuple(torch.from_numpy(x.reshape(shape)).to("cuda") for x in (a, b))


def u32_err(got, want) -> int:
    """max |got - want| of uint32 tensors; -1 if the shapes or dtypes differ."""
    import torch

    if got.dtype != torch.uint32 or want.dtype != torch.uint32 or got.shape != want.shape:
        return -1
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max().item())


def elementwise_cases():
    """(kernel, n, t, approx, fix_to_1, shape): the (n, t) sweeps (every pair
    at n <= 8 and n = 12, 2^20 + 3 draws at n = 15, 2^24 draws at n = 16),
    then the ragged, 0-d and empty sizes at the main (n, t)."""
    cases = []
    variants = [(approx, fix) for approx in (True, False) for fix in (True, False)]
    for name, widths in (("seqmul_packed", (4, 8, 12, 15)), ("seqmul_words", (8, 15, 16))):
        for n in widths:
            shape = ((1 << 24,) if n in (12, 16) else ((1 << 20) + 3,) if n == 15
                     else (1 << (2 * n),))
            for t in sorted({1, n // 2, n - 1}):
                cases += [(name, n, t, approx, fix, shape) for approx, fix in variants]
        n, t = ELEMENTWISE_MAIN[name]
        cases += [(name, n, t, True, True, shape) for shape in ELEMENTWISE_RAGGED]
    return cases


def run_elementwise_case(card: Card, case, seed: int, timed: bool):
    import torch

    from repro_torch.kernels import seqmul_kernel as sk

    name, n, t, approx, fix, shape = case
    a, b = u32_operands(shape, n, seed)
    kw = dict(n=n, t=t, approx=approx, fix_to_1=fix)
    if name == "seqmul_packed":
        kern = lambda: (sk.seqmul_packed(a, b, **kw),)
        plain = lambda: (sk.seqmul_packed_plain(a, b, **kw),)
        nbytes = 12 * a.numel()  # two uint32 reads, one write
    else:
        kern = lambda: sk.seqmul_words(a, b, **kw)
        plain = lambda: sk.seqmul_words_plain(a, b, **kw)
        nbytes = 16 * a.numel()  # two uint32 reads, two writes
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = max(u32_err(g, w) for g, w in zip(got, want))
    where = f"{name} n={n} t={t} approx={approx} fix_to_1={fix} shape={shape}"
    check(err == 0, f"{where}: kernel != plain (max |err| {err})")
    if len(shape) == 1 and shape[0] > 4:
        # an operand that does not start on a 16-byte boundary takes the
        # kernel's element-at-a-time path
        a1, b1 = a[1:], b[1:]
        fn = sk.seqmul_packed if name == "seqmul_packed" else sk.seqmul_words
        pl = sk.seqmul_packed_plain if name == "seqmul_packed" else sk.seqmul_words_plain
        g1, w1 = fn(a1, b1, **kw), pl(a1, b1, **kw)
        g1, w1 = (g1, w1) if name == "seqmul_words" else ((g1,), (w1,))
        err1 = max(u32_err(g, w) for g, w in zip(g1, w1))
        check(err1 == 0, f"{where}, unaligned view: kernel != plain (max |err| {err1})")
    bound = card.bound(nbytes, a.numel() * one_word_ops_per_product(n), card.int32_ops_per_s)
    row = dict(name=name, shape=list(shape), n=n, t=t, approx=approx, fix_to_1=fix,
               max_abs_err=err, bound_ms=bound[0], bound_by=bound[1])
    if timed:
        row["ms"] = cuda_ms(kern, reps=20, warmup=2)
        row["plain_ms"] = cuda_ms(plain, reps=2)
        row["library_ms"] = None  # no PyTorch call computes the approximate products
    return row


def phase_elementwise(card: Card) -> list:
    rows = []
    for i, case in enumerate(elementwise_cases()):
        name, n, t, approx, fix, shape = case
        timed = (n, t) == ELEMENTWISE_MAIN[name] and approx and fix and shape == (1 << 24,)
        rows.append(run_elementwise_case(card, case, seed=700 + i, timed=timed))
        if timed:
            row = rows[-1]
            print(f"kernel {name} n={n} t={t} approx fix_to_1 elements {shape[0]}: bit-equal "
                  f"ms {row['ms']:.4f} plain_ms {row['plain_ms']:.3f} library_ms none "
                  f"bound_ms {row['bound_ms']:.5f} ({row['bound_by']})", flush=True)
    for name in ELEMENTWISE_KERNELS:
        mine = [r for r in rows if r["name"] == name]
        print(f"kernel {name}: bit-equal to its plain version in all {len(mine)} cases "
              f"(n in {sorted({r['n'] for r in mine})}, t in {{1, n/2, n-1}}, approx and "
              f"fix_to_1 both ways; sizes {sorted({str(r['shape']) for r in mine})}; "
              f"unaligned views of the 1-d ones)", flush=True)
    return rows


# ------------------------------------------------------- error analysis
def phase_error_analysis() -> dict:
    """The paper's simulated error analysis on the card: ``engine.multiply``
    and ``kernels.ops.approx_multiply`` through ``seqmul_packed``, then
    ``exhaustive_eval(12, 6)`` and ``mc_eval(16, 8)``, whose products come
    from ``seqmul_words``, and ``mc_eval(32, 16)`` (``core.seqmul`` on the
    card).  Every launch count is set to 0 just before these calls and read
    just after; the comparisons with the CPU and with ``core.seqmul``
    follow, then the two example twins (in processes of their own)."""
    import numpy as np
    import torch

    from repro_torch import engine, kernels
    from repro_torch.core import error_metrics, error_model, seqmul
    from repro_torch.kernels import ops
    from repro_torch.kernels import seqmul_kernel as sk

    # the elementwise product, every (a, b) pair at n = 8, through the engine
    a, b = u32_operands((1 << 16,), 8, 0)
    kernels.reset_launch_counts()
    got = engine.multiply(a, b, n=8, t=4)  # backend "auto": the kernel
    check(kernels.launch_counts()["seqmul_packed"] == 1,
          "engine.multiply(backend='auto') on CUDA tensors did not launch seqmul_packed")
    shim = ops.approx_multiply(a, b, n=8, t=4)

    runs, reports = {}, {}

    def timed(label, fn):
        out = []
        busy_ms, _, wall_ms, _ = profile_fn(lambda: out.append(fn()), 1, label)
        runs[label] = dict(wall_s=wall_ms / 1e3, busy_share=busy_ms / wall_ms if busy_ms else None)
        reports[label] = out[0]

    for fix in (False, True):
        timed(f"exhaustive_eval(12, 6, fix_to_1={fix})",
              lambda: error_metrics.exhaustive_eval(12, 6, fix_to_1=fix, device="cuda"))
    mc_runs = ((16, 8, 1 << 24), (32, 16, 1 << 22))
    for n, t, samples in mc_runs:
        timed(f"mc_eval({n}, {t}, samples=2**{samples.bit_length() - 1})",
              lambda: error_metrics.mc_eval(n, t, samples=samples, device="cuda"))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name in ELEMENTWISE_KERNELS:
        check(counts[name] > 0, f"error analysis: {name} was never launched ({counts})")
    print(f"error analysis: launches {({k: counts[k] for k in ELEMENTWISE_KERNELS})}",
          flush=True)

    def share(label):
        busy = runs[label]["busy_share"]
        return "not measured" if busy is None else f"{busy:.4f}"

    want = engine.multiply(a, b, n=8, t=4, backend="reference")
    cpu = engine.multiply(a.cpu(), b.cpu(), n=8, t=4)
    check(u32_err(got, want) == 0 and u32_err(shim, want) == 0 and u32_err(want.cpu(), cpu) == 0,
          "engine.multiply / approx_multiply on the card != the reference body")
    print("error analysis: engine.multiply (auto) and ops.approx_multiply on the card "
          "bit-equal to the reference body on the card and on the CPU (n=8, t=4, all "
          "65536 pairs)", flush=True)

    for fix in (False, True):
        label = f"exhaustive_eval(12, 6, fix_to_1={fix})"
        rep = reports[label]
        t0 = time.perf_counter()
        ref = error_metrics.exhaustive_eval(12, 6, fix_to_1=fix, device="cpu")
        cpu_s = time.perf_counter() - t0
        check(rep == ref, f"{label}: card {rep} != CPU {ref}")
        if not fix:
            mae = error_model.mae_closed_form(12, 6)
            check(-rep.max_ed_neg == mae,
                  f"{label}: worst overshoot {-rep.max_ed_neg} != closed-form MAE {mae}")
        print(f"error analysis: {label} on the card equal to the CPU's field for field: "
              f"{rep.summary()}; worst overshoot {-rep.max_ed_neg} (closed-form MAE "
              f"{error_model.mae_closed_form(12, 6)}); wall {runs[label]['wall_s']:.2f}s on "
              f"the card (device busy share {share(label)}), {cpu_s:.2f}s on the CPU",
              flush=True)
    for n, t in ((1, 1), (4, 2)):
        check(error_metrics.exhaustive_eval(n, t, device="cuda")
              == error_metrics.exhaustive_eval(n, t, device="cpu"),
              f"exhaustive_eval({n}, {t}): card != CPU")

    for n, t, samples in mc_runs:
        label = f"mc_eval({n}, {t}, samples=2**{samples.bit_length() - 1})"
        rep = reports[label]
        small = dict(samples=1 << 16, seed=1)
        check(error_metrics.mc_eval(n, t, device="cuda", **small)
              == error_metrics.mc_eval(n, t, device="cpu", **small),
              f"mc_eval({n}, {t}) at 2^16 samples: card != CPU")
        check(rep.samples == samples and all(map(math.isfinite, (rep.er, rep.nmed, rep.mred))),
              f"{label}: {rep}")
        print(f"error analysis: {label} on the card: {rep.summary()}; wall "
              f"{runs[label]['wall_s']:.2f}s (device busy share {share(label)}); at 2^16 "
              f"samples equal to the CPU's field for field", flush=True)

    # the two-word kernel against core.seqmul on mc_eval(16, 8)'s draws
    rng = np.random.default_rng(0)
    chunk = 1 << 22
    for _ in range((1 << 24) // chunk):
        a_np = rng.integers(0, 1 << 16, size=chunk, dtype=np.uint64)
        b_np = rng.integers(0, 1 << 16, size=chunk, dtype=np.uint64)
        a16, b16 = (torch.from_numpy(x.astype(np.uint32)).to("cuda") for x in (a_np, b_np))
        low, high = sk.seqmul_words(a16, b16, n=16, t=8)
        prod = (low.cpu().numpy().astype(np.uint64)
                + (high.cpu().numpy().astype(np.uint64) << np.uint64(16)))
        words = seqmul.seq_mul_words(a16, b16, n=16, t=8, approx=True)
        check(np.array_equal(prod, seqmul.assemble_product_u64(words, n=16, t=8)),
              "seqmul_words low + (high << 16) != core.seqmul's product at n=16")
    print("error analysis: seqmul_words on mc_eval(16, 8)'s 2^24 draws: low + (high << 16) "
          "equal to core.seqmul's products on the card", flush=True)
    print("error analysis runs: " + json.dumps(runs), flush=True)

    for module, args in (("repro_torch.examples.quickstart", []),
                         ("repro_torch.examples.accuracy_sweep", ["--steps", "80"])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                              text=True, cwd=ROOT, timeout=300,
                              env={**os.environ, "PYTHONPATH": str(SRC)})
        check(proc.returncode == 0, f"{module} exit {proc.returncode}: {proc.stderr[-2000:]}")
        print(f"error analysis: python -m {module} {' '.join(args)} on the card "
              f"({time.perf_counter() - t0:.1f}s): " + " | ".join(proc.stdout.splitlines()),
              flush=True)
    return dict(counts=counts, runs=runs)


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
    want = engine.matmul(x, w, mode="lowrank", n=8, t=4, backend="reference")
    got = engine.matmul(x.cuda(), w.cuda(), mode="lowrank", n=8, t=4, backend="cuda").cpu()
    err = (got - want).abs().max().item()
    check(err <= 2e-6 * want.abs().max().item(),
          f"engine.matmul lowrank: card vs CPU reference max |err| {err}")
    print(f"reference: engine.matmul lowrank on the card vs the CPU reference body at "
          f"(16,128)x(128,64): max |err| {err:.3e} (2e-6 * max|want|)", flush=True)
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

    reduced = get_config("qwen3-0.6b").reduced()
    pallas = get_config("qwen3-0.6b").reduced(attn_impl="pallas")
    for label, cfg in (("exact", reduced),
                       ("bitexact", apply_approx(reduced, mode="bitexact", n=8, t=4)),
                       ("pallas exact", pallas),
                       ("pallas bitexact mlp+attn", apply_approx(
                           pallas, mode="bitexact", n=8, t=4, targets=("mlp", "attn")))):
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
        # All within rtol/atol 1e-4: the float sums (norms, attention, the
        # exact projections) run in another order on the card.  The bitexact
        # GEMMs are integer-exact on both sides, so they add nothing unless an
        # input lands on the other side of a quantizer rounding boundary,
        # which moves a logit by far more than 1e-4 and fails here; so does
        # a probability of the approximate attention that the card's expf
        # moves across a boundary of p_int.
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
              f"reduced {label} prefill: card vs CPU max |err| {err}")
        print(f"reference: reduced qwen3-0.6b {label} prefill logits card vs CPU "
              f"max |err| {err:.3e} (rtol/atol 1e-4)", flush=True)


# ---------------------------------------------------------------- serve
def phase_serve(label: str, params, model, *, quality=None, mode=None, targets=("mlp",),
                expect=(), forbid=(), requests: int):
    """One closed-loop run of the scheduler; every kernel in ``expect`` must
    launch and none in ``forbid``."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs.registry import apply_approx
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ContinuousScheduler, synth_requests

    if mode is not None:
        model = build_model(apply_approx(model.cfg, mode=mode, targets=targets))
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
    for name in expect:
        check(counts[name] > 0, f"{label}: {name} was never launched ({counts})")
    for name in forbid:
        check(counts[name] == 0, f"{label}: {name} ran in this pool ({counts})")
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
    return dict(counts=counts, tok_s=st.tokens_per_s, wall_s=st.wall_s, queue=queue,
                outputs=result.outputs, model=sched.model, modeled_cost=st.modeled_cost,
                **steps)


def teacher_gaps(model, params, req, stream) -> list:
    """The top-2 logit gap of each greedy step of ``stream``, by one forward
    of the prompt and the stream (teacher forcing) at batch 1, unpadded."""
    import numpy as np
    import torch

    toks = np.concatenate([req.tokens, stream[:-1]]).astype(np.int64)
    with torch.inference_mode():
        x = torch.as_tensor(toks[None], device="cuda")
        pos = torch.arange(len(toks), device="cuda")[None]
        hidden, _ = model.forward(params, x, pos, model.ctx())
        logits = model.lm_head(params, hidden[:, req.prompt_len - 1:])[0]
        top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).tolist()


def hold_streams(label: str, queue, got: dict, want: dict, model, params) -> str:
    """The margin rule: ``got``'s stream of each request must equal ``want``'s
    up to the request's first greedy step whose top-2 gap is under
    ``STREAM_MARGIN``; past it, agreement is reported, not required."""
    import numpy as np

    equal, after_tie = 0, []
    for r in queue:
        a, b = np.asarray(got[r.id]), np.asarray(want[r.id])
        check(len(a) == len(b), f"{label}: request {r.id} has {len(a)} tokens, want {len(b)}")
        if np.array_equal(a, b):
            equal += 1
            continue
        j = int(np.flatnonzero(a != b)[0])
        gaps = teacher_gaps(model, params, r, b)
        tie = next((i for i, g in enumerate(gaps) if g < STREAM_MARGIN), None)
        check(tie is not None and tie <= j,
              f"{label}: request {r.id} diverged at step {j} before any near tie "
              f"(top-2 gaps {[round(g, 4) for g in gaps[:j + 1]]})")
        after_tie.append(f"{r.id}@{j} (gap {gaps[tie]:.4f} at step {tie})")
    return (f"streams equal {equal} of {len(queue)}"
            + (f", diverged after a near tie (margin {STREAM_MARGIN}): {', '.join(after_tie)}"
               if after_tie else ""))


def phase_serve_speculative(label: str, params, greedy: dict, *, expect: tuple,
                            draft_run: dict = None) -> dict:
    """``SelfSpeculative(k=SPEC_K, draft_tier="draft")`` on the exact pool of
    ``greedy``'s run, over its queue; the streams held against greedy's.
    Launches per round are counted around each decode round.  With
    ``draft_run`` (the plain draft pool's run on the same queue), also the
    degenerate pair draft = verify = exact over the first batch, whose
    proposals the verify forward recomputes, and the share of first tokens
    the draft pool and the exact pool agree on."""
    import collections

    import torch

    from repro_torch import kernels
    from repro_torch.serve import ContinuousScheduler, SelfSpeculative

    queue = greedy["queue"]
    shape = dict(batch_size=SERVE["batch"], prompt_len=SERVE["prompt"], max_new=SERVE["gen"],
                 quality="exact")
    sched = ContinuousScheduler(greedy["model"], params, **shape,
                                strategy=SelfSpeculative(k=SPEC_K, draft_tier="draft"))
    in_rounds, rounds = collections.Counter(), [0]
    decode_round = sched.strategy.decode_round

    def counted_round(*args, **kw):
        before = kernels.launch_counts()
        rr = decode_round(*args, **kw)
        after = kernels.launch_counts()
        in_rounds.update({k: after[k] - before[k] for k in after})
        rounds[0] += 1
        return rr

    sched.strategy.decode_round = counted_round
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = sched.run(queue)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    st, acc = result.stats, result.accounting
    for name in expect:
        check(counts[name] > 0, f"{label}: {name} was never launched ({counts})")
    check(st.requests == len(queue) and acc.slot_leaks == 0 and acc.position_violations == 0,
          f"{label}: served {st.requests} of {len(queue)}, accounting {acc}")
    check(st.spec_rounds == rounds[0] and st.spec_proposed == sum(
        r.proposed for r in result.request_stats),
          f"{label}: speculated rounds {st.spec_rounds} of {rounds[0]}, proposed "
          f"{st.spec_proposed}")
    agree = hold_streams(label, queue, result.outputs, greedy["outputs"], sched.model, params)
    per_round = {k: v / rounds[0] for k, v in in_rounds.items() if v}
    extra = ""
    if draft_run is not None:
        first = queue[:SERVE["batch"]]
        same = ContinuousScheduler(greedy["model"], params, **shape,
                                   strategy=SelfSpeculative(k=SPEC_K, draft_tier="exact"))
        deg = same.run(first)
        torch.cuda.synchronize()
        deg_agree = hold_streams(f"{label} draft=exact", first, deg.outputs,
                                 greedy["outputs"], sched.model, params)
        firsts = sum(int(draft_run["outputs"][r.id][0] == greedy["outputs"][r.id][0])
                     for r in queue)
        extra = (f"; degenerate pair draft = verify = exact over {len(first)} requests: "
                 f"accept {deg.stats.spec_accepted}/{deg.stats.spec_proposed}, {deg_agree}; "
                 f"the draft pool's first token equals the exact pool's in {firsts} of "
                 f"{len(queue)} requests")
    print(f"serve {label}: {st.summary()}; k={SPEC_K} draft tier draft, verify exact: accept "
          f"{st.spec_accepted}/{st.spec_proposed} = {st.accept_rate:.4f} over {st.spec_rounds} "
          f"rounds, {st.decode_steps} forwards, modeled cost {st.modeled_cost:.2f} (greedy "
          f"{greedy['modeled_cost']:.2f}), {st.tokens_per_s:.2f} tok/s (greedy "
          f"{greedy['tok_s']:.2f}); launches {counts} (warmup included), per round "
          f"{per_round}; {agree}; run incl. warmup {wall:.2f}s{extra}", flush=True)
    return dict(counts=counts, per_round=per_round, accept_rate=st.accept_rate,
                tok_s=st.tokens_per_s)


def phase_serve_open(params, model) -> dict:
    """The open loop at full width: the ``bursty`` preset, virtual clock,
    ``SLOAdaptive`` on its default ladder (high, balanced, draft).  No
    request has an EOS, so the schedule does not depend on the model: the
    switch sequence and every request's ``queue_delay_s`` and ``ttft_s``
    must equal those of reduced qwen3-0.6b on the CPU, run here too."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ContinuousScheduler, SLOAdaptive
    from repro_torch.serve.workload import generate, preset_spec

    spec = preset_spec("bursty", requests=2 * SERVE["requests"], prompt_len=SERVE["prompt"],
                       max_new=SERVE["gen"], vocab_size=model.cfg.vocab_size,
                       slo_ttft_s=OPEN_SLO_TTFT_MS / 1e3)
    draw = generate(spec, seed=0)
    run = dict(arrivals_s=list(draw.arrivals_s), step_time_s=0.01, clock="virtual")
    shape = dict(batch_size=SERVE["batch"], prompt_len=SERVE["prompt"], max_new=SERVE["gen"],
                 quality="high")
    sched = ContinuousScheduler(model, params, **shape)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = sched.run(list(draw.requests), policy=SLOAdaptive(slo_ttft_s=spec.slo_ttft_s),
                       **run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    small = build_model(get_config("qwen3-0.6b").reduced())
    cpu = ContinuousScheduler(small, small.init_params(0, device="cpu"), **shape).run(
        [dataclasses.replace(r, tokens=r.tokens % small.cfg.vocab_size) for r in draw.requests],
        policy=SLOAdaptive(slo_ttft_s=spec.slo_ttft_s), **run)
    st = result.stats
    switches = [(w.step, w.now_s, w.from_tier, w.to_tier, w.reason)
                for w in result.tier_switches]
    check(switches == [(w.step, w.now_s, w.from_tier, w.to_tier, w.reason)
                       for w in cpu.tier_switches],
          f"open loop: switches {switches} on the card, {cpu.tier_switches} on the CPU")
    check(len(switches) >= 1, "open loop: the policy never switched tiers")
    timing = lambda res: sorted((r.id, r.queue_delay_s, r.ttft_s, r.tier_served)
                                for r in res.request_stats)
    check(timing(result) == timing(cpu), "open loop: per-request queue delays differ from the "
                                         "CPU run's")
    check(st.requests == len(draw.requests) and st.starved == 0
          and result.accounting.slot_leaks == 0, f"open loop: {st}")
    for name in ("lut_matmul", "packed_matmul"):
        check(counts[name] > 0, f"open loop: {name} was never launched ({counts})")
    print(f"serve open slo-adaptive: bursty preset, {len(draw.requests)} requests offered at "
          f"{draw.offered_rps:.1f} rps (virtual clock, step 10 ms, TTFT SLO "
          f"{OPEN_SLO_TTFT_MS:.0f} ms): {st.summary()}; switches {switches}, equal to the CPU "
          f"run's with every request's queue_delay_s and ttft_s; launches {counts}; run incl. "
          f"warmup {wall:.2f}s", flush=True)
    return dict(counts=counts, switches=len(switches))


def phase_serve_static(params, model) -> dict:
    """The static-batch loop at ``exact`` on 16 prompts of the bucket's
    length (every row then sits at its true positions), held against the
    continuous scheduler on the same queue by the margin rule."""
    import torch

    from repro_torch import kernels
    from repro_torch.serve import ContinuousScheduler, static_serve_loop, synth_requests

    queue = synth_requests(SERVE["requests"], prompt_len=SERVE["prompt"], gen=SERVE["gen"],
                           vocab_size=model.cfg.vocab_size, seed=1,
                           min_prompt=SERVE["prompt"], vary_budget=False)
    shape = dict(batch_size=SERVE["batch"], prompt_len=SERVE["prompt"])
    cont = ContinuousScheduler(model, params, max_new=SERVE["gen"], **shape).run(queue)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = static_serve_loop(model, params, queue, gen=SERVE["gen"], **shape)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(not any(counts.values()), f"serve static: a kernel ran at exact ({counts})")
    st = result.stats
    check(st.requests == len(queue) and st.tokens_out == len(queue) * SERVE["gen"],
          f"serve static: {st}")
    agree = hold_streams("serve static", queue, result.outputs, cont.outputs, model, params)
    print(f"serve static: {st.summary()}; {st.decode_steps} decode steps (continuous "
          f"{cont.stats.decode_steps}, {cont.stats.tokens_per_s:.2f} tok/s); against the "
          f"continuous scheduler: {agree}; run incl. warmup {wall:.2f}s", flush=True)
    return dict(tok_s=st.tokens_per_s)


def phase_soak(params, model) -> dict:
    """``run_soak`` at full width: the ``steady`` preset, 64 requests in
    windows of 32, two parity spot-checks (each re-served alone, unpadded,
    through the static loop, bit-equal)."""
    import torch

    from repro_torch.serve.soak import run_soak
    from repro_torch.serve.workload import preset_spec

    spec = preset_spec("steady", requests=4 * SERVE["requests"], prompt_len=SERVE["prompt"],
                       max_new=SERVE["gen"], vocab_size=model.cfg.vocab_size)
    t0 = time.perf_counter()
    report = run_soak(model, params, spec, batch_size=SERVE["batch"], seed=0, window_size=32,
                      spot_check=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = report.summary_row()
    check(report.ok and row["invariants_ok"] == 1.0, f"soak: {report.violations}")
    check(row["spot_checks"] == 2 and row["spot_check_failures"] == 0, f"soak: {row}")
    print(f"soak: {report.describe()}; {json.dumps(row)}; run {wall:.2f}s", flush=True)
    return row


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
    return profile_fn(lambda: eng.decode(params, caches, tok, at, at)[0].cpu(), reps,
                      "decode step")


def profile_fn(fn, reps: int, what: str):
    """Device time over ``reps`` calls of ``fn``, which ends in a sync: (busy
    ms, ms in the port's kernels, host-clock ms, reps).  Busy is the sum of
    kernel times on the one stream the calls use."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
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
    print(f"profile: per {what} {launches / reps:.0f} launches through the CUDA runtime "
          f"seen; host self time by op: {top}", flush=True)
    return busy_us / 1e3, kernel_us / 1e3, wall_ms, reps


# ---------------------------------------------------------------- train
def phase_train(label: str, model, *, expect: tuple, seed: int = 0) -> dict:
    """``TRAIN["steps"]`` steps of ``make_train_step`` through ``run_loop`` at
    full width from seed-0 weights and ``SyntheticLM`` data: the loss must
    be finite and fall, every kernel in ``expect`` must launch.  Then one
    more step under the profiler for the device's busy share."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.runtime.fault import run_loop
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = model.cfg
    b, seq, n = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    # the reference driver's TrainConfig for --steps n
    tcfg = TrainConfig(learning_rate=3e-4, total_steps=n, warmup_steps=max(10, n // 20),
                       seed=seed)
    t0 = time.perf_counter()
    state = init_train_state(model, tcfg, seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=b,
                                  seed=seed))

    def batch_fn(step: int) -> dict:
        return {k: torch.as_tensor(v, device="cuda") for k, v in data.batch(step).items()}

    step_fn = make_train_step(model, tcfg)
    times = []

    def timed(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    kernels.reset_launch_counts()
    result = run_loop(state, timed, batch_fn, total_steps=n)
    counts = kernels.launch_counts()
    losses = [h["loss"] for h in result.metrics_history]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(len(losses) == n and all(np.isfinite(losses)), f"train {label}: losses {losses}")
    check(last < first, f"train {label}: loss did not fall ({first} -> {last}): {losses}")
    for name in expect:
        check(counts[name] > 0, f"train {label}: {name} was never launched ({counts})")
    step_ms = float(np.median(times[1:])) * 1e3
    per_step = {k: v / n for k, v in counts.items() if v}
    busy_ms, kernel_ms, wall_ms, _ = profile_fn(lambda: timed(result.state, batch_fn(n)), 1,
                                                "train step")
    share = (f"device busy {busy_ms / wall_ms:.3f} of {wall_ms:.1f} ms, own kernels "
             f"{kernel_ms / max(busy_ms, 1e-9):.3f} of busy" if busy_ms else
             "device busy share not measured (the profiler saw no device time)")
    print(f"train {label}: {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}, batch {b} x seq {seq}, {n} steps "
          f"(init {init_s:.1f}s): loss {first:.4f} -> {last:.4f} (steps 1 and 2: "
          f"{losses[0]:.6f}, {losses[1]:.6f}); step {step_ms:.1f} ms "
          f"(first {times[0] * 1e3:.1f} ms), {b * seq / step_ms * 1e3:.0f} train tokens/s; "
          f"launches per step {per_step}; {share}", flush=True)
    return dict(counts=counts, per_step=per_step, step_ms=step_ms, first=first, last=last,
                losses=losses, busy_share=busy_ms / wall_ms if busy_ms else None)


def phase_train_reference() -> None:
    """One train step's loss and gradients of reduced qwen3-0.6b, bitexact on
    mlp and attn with attn_impl="pallas", on the card against the CPU, from
    the same seeded weights and batch: loss within rtol 1e-5 and every
    gradient within 1e-4 * max|want| (the CPU tests' tolerances against the
    JAX package; float32 sums run in another order on the card)."""
    import torch

    from repro_torch.configs.registry import apply_approx, get_config
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import loss_fn

    cfg = apply_approx(get_config("qwen3-0.6b").reduced(attn_impl="pallas"), mode="bitexact",
                       n=8, t=4, targets=("mlp", "attn"))
    model = build_model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(5))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    results = []
    for device in ("cpu", "cuda"):
        params = model.init_params(0, device="cpu").to(device)
        loss, _ = loss_fn(params, {k: v.to(device) for k, v in batch.items()}, 0, model)
        loss.backward()
        results.append((loss.item(), {n: p.grad.cpu() for n, p in params.named_parameters()}))
    (want_loss, want), (got_loss, got) = results
    check(abs(got_loss - want_loss) <= 1e-5 * abs(want_loss),
          f"reduced train step: card loss {got_loss} vs CPU {want_loss}")
    worst = 0.0
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        limit = 1e-4 * w.abs().max().item()
        check(err <= limit, f"reduced train step: {name} gradient max |err| {err} over {limit}")
        worst = max(worst, err / max(w.abs().max().item(), 1e-30))
    print(f"reference: reduced qwen3-0.6b train step (bitexact mlp+attn, pallas) card vs CPU: "
          f"loss {got_loss:.6f} vs {want_loss:.6f}, worst gradient max |err| / max|want| "
          f"{worst:.3e} over {len(want)} tensors (limits rtol 1e-5, 1e-4)", flush=True)


def phase_train_cli() -> None:
    """The train CLI on the card: full-width paper-multiplier, a checkpoint
    every 4 steps and a failure injected at step 5; it must recover from the
    step-4 checkpoint and print its loss line."""
    import re
    import shutil

    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    history = ROOT / "build" / "chip_smoke_train_history.json"
    shutil.rmtree(ckpt, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "paper-multiplier",
           "--steps", "8", "--batch", "8", "--seq", "128", "--ckpt-dir", str(ckpt),
           "--ckpt-every", "4", "--inject-failures", "5", "--log-every", "2",
           "--out", str(history)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=600,
                              env={**os.environ, "PYTHONPATH": str(SRC)})
        # the CLI's "loss a -> b" averages the first and last ten steps, which
        # over 8 steps are the same steps: the first and last losses say more
        losses = ([h["loss"] for h in json.loads(history.read_text())]
                  if proc.returncode == 0 else [])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        history.unlink(missing_ok=True)
    wall = time.perf_counter() - t0
    out = proc.stdout
    check(proc.returncode == 0, f"train CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    m = re.search(r"loss ([-\d.naif]+) -> ([-\d.naif]+)\s+failures=(\d+) restarts=(\d+)", out)
    check(m is not None, f"train CLI printed no loss line: {out[-2000:]}")
    a, b = float(m.group(1)), float(m.group(2))
    failures, restarts = int(m.group(3)), int(m.group(4))
    check("recovered from step 4" in out, f"train CLI did not recover from step 4: {out[-2000:]}")
    check(failures == 1 and restarts == 1 and all(map(math.isfinite, (a, b))),
          f"train CLI: {m.group(0)}")
    # a step between the restored checkpoint and the failure runs twice
    check(len(losses) >= 8 and all(map(math.isfinite, losses)), f"train CLI losses {losses}")
    lines = [ln for ln in out.splitlines() if ln.startswith(("arch=", "recovered", "loss"))]
    print(f"train CLI ({wall:.1f}s): " + " | ".join(lines)
          + f" | losses of steps 1 and 8: {losses[0]:.6f}, {losses[-1]:.6f}", flush=True)


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
          f"{card.lookups_per_s / 1e12:.2f} T/s, float32 "
          f"{card.f32_flops_per_s / 1e12:.2f} TFLOP/s", flush=True)

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
    sass_checks = (("flash_attention", ("flash_attention_kernel",), ("flash_decode_kernel",)),
                   ("flash_attention_bwd", ("bwd_dq_kernel", "bwd_dkv_kernel"), ()),
                   ("approx_attention", ("lowrank_kernel",), ("bitexact_kernel",)))
    for source, names, without in sass_checks:
        for kernel, count in sorted(tensor_core_instructions(source, names, without).items()):
            print(f"build: {source} SASS: {kernel} HMMA/HGMMA/IMMA per instantiation {count}",
                  flush=True)

    # 3. kernels
    rows = (phase_kernels(card) + phase_attention(card) + phase_backward(card)
            + phase_elementwise(card))
    kernels.reset_launch_counts()

    # 4. reference
    phase_reference()
    phase_train_reference()
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
    every = tuple(kernels.ALL)
    n_req = SERVE["requests"]
    exact_run = phase_serve("exact", params, model, quality="exact", forbid=every,
                            requests=n_req)
    runs = {
        "lut_matmul": phase_serve("balanced", params, model, quality="balanced",
                                  expect=("lut_matmul",), forbid=ATTN_KERNELS,
                                  requests=n_req),
        "packed_matmul": phase_serve("draft", params, model, quality="draft",
                                     expect=("packed_matmul",), requests=n_req),
        "seqmul_matmul": phase_serve("seqmul", params, model, mode="seqmul",
                                     expect=("seqmul_matmul",), requests=n_req // 2),
    }
    # attn_impl="pallas": the attention kernels on the same weights
    pallas = build_model(dataclasses.replace(cfg, attn_impl="pallas"))
    runs["flash_attention"] = runs["flash_decode"] = phase_serve(
        "pallas exact", params, pallas, quality="exact",
        expect=("flash_attention", "flash_decode"), forbid=GEMM_KERNELS, requests=n_req)
    runs["approx_attention_bitexact"] = phase_serve(
        "pallas balanced", params, pallas, quality="balanced",
        expect=("approx_attention_bitexact", "flash_decode", "lut_matmul"), requests=n_req)
    runs["lowrank_matmul"] = runs["approx_attention_lowrank"] = phase_serve(
        "pallas lowrank mlp+attn", params, pallas, mode="lowrank", targets=("mlp", "attn"),
        expect=("lowrank_matmul", "approx_attention_lowrank", "flash_decode"),
        requests=n_req)
    # the rest of serving: speculative rounds (draft proposals, one verify
    # forward), the open loop with its policy, the static loop, the soak
    spec_runs = {"packed_matmul": phase_serve_speculative(
        "speculative", params, exact_run, expect=("packed_matmul",),
        draft_run=runs["packed_matmul"])}
    pallas_exact = runs["flash_attention"]
    pallas_half = {**pallas_exact, "queue": pallas_exact["queue"][:n_req // 2]}
    spec_runs["flash_attention"] = spec_runs["flash_decode"] = phase_serve_speculative(
        "pallas speculative", params, pallas_half,
        expect=("flash_decode", "flash_attention", "packed_matmul"))
    phase_serve_open(params, model)
    phase_serve_static(params, model)
    phase_soak(params, model)
    del params
    torch.cuda.empty_cache()

    # 6. train, full width, attn_impl="pallas" (set on the config; the CLI has no flag)
    from repro_torch.configs.registry import apply_approx

    paper = build_model(dataclasses.replace(get_config("paper-multiplier"), attn_impl="pallas"))
    train_runs = {"paper-multiplier": phase_train(
        "paper-multiplier pallas", paper,
        expect=("lut_matmul", "flash_attention", *BWD_KERNELS))}
    bitexact = build_model(apply_approx(dataclasses.replace(cfg, attn_impl="pallas"),
                                        mode="bitexact", n=8, t=4, targets=("mlp", "attn")))
    train_runs["bitexact"] = phase_train(
        "qwen3-0.6b bitexact mlp+attn pallas", bitexact,
        expect=("lut_matmul", "approx_attention_bitexact", *BWD_KERNELS))
    for name in BWD_KERNELS:
        runs[name] = dict(counts=train_runs["paper-multiplier"]["counts"],
                          per_step=train_runs["paper-multiplier"]["per_step"])
    torch.cuda.empty_cache()
    phase_train_cli()

    # 7. the paper's simulated error analysis: engine.multiply through
    # seqmul_packed, the error reports up to n = 16 through seqmul_words
    analysis = phase_error_analysis()
    for name in ELEMENTWISE_KERNELS:
        runs[name] = analysis

    # 8. report
    table = []
    for name in GEMM_KERNELS + ATTN_KERNELS + BWD_KERNELS + ELEMENTWISE_KERNELS:
        mine = [r for r in rows if r["name"] == name]
        if name in GEMM_KERNELS:
            main_row = next(r for r in mine
                            if tuple(r["shape"]) == MAIN_SHAPE and r["n"] == 8 and "ms" in r)
        elif name in BWD_KERNELS:
            main_row = next(r for r in mine if r["label"] == "train")
        elif name in ELEMENTWISE_KERNELS:
            main_row = next(r for r in mine if "ms" in r)
        else:
            main_row = next(r for r in mine if r["label"] == "serve")
        if name in BWD_KERNELS:
            per_step = dict(launches_per_train_step=runs[name]["per_step"][name])
        elif name in ELEMENTWISE_KERNELS:
            per_step = dict(n=main_row["n"], t=main_row["t"])
        else:
            # the main-path serve run's pool prefill and decode step around them
            per_step = dict(launches_per_prefill=runs[name]["per_prefill"][name],
                            launches_per_decode_step=runs[name]["per_decode"][name],
                            serve_prefill_ms=runs[name]["prefill_ms"],
                            serve_decode_step_ms=runs[name]["decode_ms"],
                            serve_busy_share=runs[name]["busy_share"])
            if name == "approx_attention_bitexact":
                # and in each step of train run (b), at the train row's shape
                per_step["launches_per_train_step"] = train_runs["bitexact"]["per_step"][name]
        if name in spec_runs:
            # each round of the speculative run: SPEC_K draft decodes and one verify
            per_step["launches_per_spec_round"] = spec_runs[name]["per_round"].get(name, 0.0)
        if "exact_matmul_ms" in main_row:
            per_step["exact_matmul_ms"] = main_row["exact_matmul_ms"]
        table.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCES.get(name, name)}.cu",
            "replaces": REPLACES[name],
            "launches": runs[name]["counts"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            **{key: main_row[key] for key in ("device_ms", "library_device_ms",
                                              "device_ms_mag_below_64", "err_over_limit",
                                              "plan", "skipped_pairs", "skipped_chunks")
               if key in main_row},
            "shape": main_row["shape"],
            **per_step,
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
