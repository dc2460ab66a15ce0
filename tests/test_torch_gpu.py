"""Each CUDA kernel of the port against its plain version, on the card.

Every test here is marked ``gpu`` and skips without an NVIDIA Hopper
(sm_90) card.  The file imports torch and numpy only, so that it runs
where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances (kernel against plain version, both on the card):
- the integer GEMMs (lut, seqmul, packed): bit-equal, ``packed_matmul``
  also at its edge cases (every plane pair at its extreme, odd K, M = 1,
  ragged shapes), ``lut_matmul`` and ``seqmul_matmul`` at every M of the
  serve and train paths, ragged and split shapes, every magnitude at
  2^n - 1, seqmul at every (n, t), lut at n = 1, 4, 8, int64 sums;
- ``lowrank_matmul``: max |err| <= 2e-6 * max |want|: the exact part is an
  integer on both sides, the float32 correction is summed in another order
  (split TF32 on the tensor cores); bit-equal with zero SVD tables;
- the split-K GEMMs (packed, lowrank, lut, seqmul): two launches give the
  same bits; all four ``launch_plan``s equal the built plans;
- ``flash_attention`` / ``flash_decode``: 2e-5, the reference's flash
  tolerance, for float32 sums in another order (and the forward's bf16
  tensor-core products of split float32 operands); two launches give the
  same bits, the work each skips, counted on the card, is the plan's
  (``fwd_tile_plan``, ``decode_chunk_plan``), and ``launch_plan`` equals
  the built plan;
- ``approx_flash_attention``: within one probability quantum, max|v| /
  (2^n - 1), everywhere, and 1e-5 for 99% of the outputs: the sums of l
  (both modes) and of the lowrank scores run in another order, and an ulp
  there can move a ``p_int`` across a rounding boundary; two launches give
  the same bits, and ``launch_plan`` equals the built plan;
- the flash backward (dq, dk/dv kernels): within 1e-4 * max|want| per
  output, float32 before the cast (sums of up to T terms in another order);
- the elementwise multiplier (``seqmul_packed``, ``seqmul_words``):
  bit-equal;
- ``moe_ffn`` at granite-moe-1b-a400m's widths: two launches bit-identical;
- the static certifier: every built instantiation's block within
  Hopper's limits (registers from ``-Xptxas -v``), and the armed gate
  (``REPRO_STATIC_AUDIT=1``) refusing an uncertified launch before it;
- distribution under a one-rank NCCL group (a ``FileStore``, no network):
  the scheduler's streams under a ``("data",)`` mesh equal ``mesh=None``'s
  at exact, balanced and draft; a train state sharded over a (1, 1) mesh
  restores onto the card and onto the CPU bit for bit;
- tensor parallelism: the integer epilogue of lut, packed and seqmul
  (each K shard equal to its plain version, the shards' int64 sums to the
  whole K's); the decode's lse and its (o, lse) over 2 and 4 slot ranges
  combined within 2e-5 of the whole decode; on a one-rank (1, 1) NCCL mesh
  the sharded train step's losses within rtol 1e-5 of ``mesh=None``'s and
  the balanced streams equal.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper (sm_90) card")
    return torch.device("cuda")


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k**-0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("kernel", ["lut_matmul", "seqmul_matmul", "packed_matmul"])
def test_kernel_bitmatches_plain_version_on_the_card(kernel, card):
    from repro_torch.engine import artifacts
    from repro_torch.engine.modes import quantize_operands
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import seqmul_matmul as sm

    x, w = (torch.from_numpy(a).to(card) for a in _operands(33, 300, 70, seed=1))
    (mx, sx), (mw, sw), _ = quantize_operands(x, w, 8)
    if kernel == "lut_matmul":
        lut = artifacts.product_lut_u16(8, 4, True, x.device)
        args = (lut, mx.to(torch.uint8), sx, mw.to(torch.uint8), sw)
        got, want = lm.lut_matmul(*args, n=8), lm.lut_matmul_plain(*args, n=8)
    elif kernel == "seqmul_matmul":
        args = (mx.to(torch.int16), sx, mw.to(torch.int16), sw)
        got, want = sm.seqmul_matmul(*args, n=8, t=4), sm.seqmul_matmul_plain(*args, n=8, t=4)
    else:
        pa = pm.pack_i16_pairs(mx * sx.to(torch.int32), dim=1)
        pb = pm.pack_i16_pairs(mw * sw.to(torch.int32), dim=0)
        got, want = pm.packed_matmul(pa, pb, n=8), pm.packed_matmul_plain(pa, pb)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(4, 1024, 3072), (33, 300, 70), (128, 3072, 1024)])
def test_lowrank_matmul_matches_plain_version(m, k, n, card):
    from repro_torch.engine import artifacts
    from repro_torch.engine.modes import quantize_operands
    from repro_torch.kernels import lowrank_matmul as lr

    x, w = (torch.from_numpy(a).to(card) for a in _operands(m, k, n, seed=m + k))
    (mx, sx), (mw, sw), _ = quantize_operands(x, w, 8)
    u, v, _ = artifacts.svd_factors(8, 4, 8, True, card)
    args = (u, v, mx.to(torch.uint8), sx, mw.to(torch.uint8), sw)
    got, want = lr.lowrank_matmul(*args, n=8), lr.lowrank_matmul_plain(*args, n=8)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-6 * want.abs().max().item()


def _bits(x):
    return x.view(torch.int32)


def _packed_edge_operands(case, card):
    """(pa, pb, n) of one packed edge case: lanes at +-(2^n - 1) (signs
    mixed or all alike, so the sums reach K * (2^n - 1)^2), an odd K
    (a zero pad lane), M = 1 and a ragged shape."""
    rng = np.random.default_rng(len(case))
    kind, m, k, n_cols, n = case
    qmax = (1 << n) - 1
    if kind == "extreme mixed":
        a = rng.choice([-qmax, qmax], size=(m, k))
        b = rng.choice([-qmax, qmax], size=(k, n_cols))
    elif kind == "extreme alike":
        a, b = np.full((m, k), qmax), np.full((k, n_cols), -qmax)
    else:
        a = rng.integers(-qmax, qmax + 1, size=(m, k))
        b = rng.integers(-qmax, qmax + 1, size=(k, n_cols))
    from repro_torch.kernels import packed_matmul as pm

    pa = pm.pack_i16_pairs(torch.from_numpy(a).to(card), dim=1)
    pb = pm.pack_i16_pairs(torch.from_numpy(b).to(card), dim=0)
    return pa, pb, n


PACKED_EDGES = [
    ("extreme mixed", 4, 3072, 1024, 8), ("extreme alike", 4, 3072, 1024, 8),
    ("extreme mixed", 128, 3072, 1024, 15), ("extreme alike", 4, 3072, 1024, 15),
    ("random", 4, 301, 64, 12), ("random", 1, 1024, 3072, 8), ("random", 33, 300, 70, 15),
    # granite-moe-1b-a400m's expert GEMMs (draft tier): one slot per expert in
    # a decode step, 40 in a pool prefill; up/gate (1024, 512), down (512, 1024)
    ("random", 1, 1024, 512, 8), ("random", 40, 1024, 512, 8), ("random", 1, 512, 1024, 8),
    ("random", 40, 512, 1024, 8),
]


@pytest.mark.parametrize("case", PACKED_EDGES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}x{c[3]}-n{c[4]}")
def test_packed_matmul_edge_cases_bitmatch_and_repeat(case, card):
    """Bit-equal to the plain version at the extremes of every plane pair
    (int32 sums at n = 8, int64 at n = 15), at an odd K, M = 1 and a
    ragged shape; two launches give the same bits (split-K order)."""
    from repro_torch.kernels import packed_matmul as pm

    pa, pb, n = _packed_edge_operands(case, card)
    got, again = pm.packed_matmul(pa, pb, n=n), pm.packed_matmul(pa, pb, n=n)
    want = pm.packed_matmul_plain(pa, pb)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(again))


LOWRANK_EDGES = [("mag 255", 4, 1024, 3072), ("mag 255", 128, 1024, 3072),
                 ("zero tables", 4, 3072, 1024), ("zero tables", 33, 300, 70),
                 ("random", 1, 1024, 3072), ("random", 33, 300, 70),
                 ("rank 24", 33, 300, 70), ("rank 24", 4, 1024, 3072)]


@pytest.mark.parametrize("case", LOWRANK_EDGES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}x{c[3]}")
def test_lowrank_matmul_edge_cases(case, card):
    """Every magnitude 255 with mixed signs, zero SVD tables (then the
    exact part alone: bit-equal), M = 1, a ragged shape, and rank 24 (three
    blocks of 8 r per K step); within 2e-6 * max|want| otherwise; two
    launches give the same bits."""
    from repro_torch.engine import artifacts
    from repro_torch.kernels import lowrank_matmul as lr

    kind, m, k, n_cols = case
    rng = np.random.default_rng(m + k)
    mag_a = rng.integers(0, 256, size=(m, k))
    mag_b = rng.integers(0, 256, size=(k, n_cols))
    if kind == "mag 255":
        mag_a, mag_b = np.full_like(mag_a, 255), np.full_like(mag_b, 255)
    sign_a = rng.choice([-1, 0, 1], size=(m, k), p=[0.45, 0.1, 0.45])
    sign_b = rng.choice([-1, 1], size=(k, n_cols))
    u, v, _ = artifacts.svd_factors(8, 4, 24 if kind == "rank 24" else 8, True, card)
    if kind == "zero tables":
        u, v = torch.zeros_like(u), torch.zeros_like(v)
    args = (u, v, torch.from_numpy(mag_a).to(card, torch.uint8),
            torch.from_numpy(sign_a).to(card, torch.int8),
            torch.from_numpy(mag_b).to(card, torch.uint8),
            torch.from_numpy(sign_b).to(card, torch.int8))
    got, again = lr.lowrank_matmul(*args, n=8), lr.lowrank_matmul(*args, n=8)
    want = lr.lowrank_matmul_plain(*args, n=8)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again))
    if kind == "zero tables":
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= 2e-6 * want.abs().max().item()


def _sign_magnitude(m, k, n_cols, n, seed, card, kind="random"):
    """Magnitudes in [0, 2^n) (all 2^n - 1 for "extreme") and signs in
    {-1, 0, 1}, mixed, as int16 / int8 tensors on the card."""
    rng = np.random.default_rng(seed)
    qmax = (1 << n) - 1
    mag_a, mag_b = rng.integers(0, qmax + 1, (m, k)), rng.integers(0, qmax + 1, (k, n_cols))
    if kind == "extreme":
        mag_a, mag_b = np.full_like(mag_a, qmax), np.full_like(mag_b, qmax)
    sign_a = rng.choice([-1, 0, 1], (m, k), p=[0.45, 0.1, 0.45])
    sign_b = rng.choice([-1, 0, 1], (k, n_cols), p=[0.45, 0.1, 0.45])
    return (torch.from_numpy(mag_a).to(card, torch.int16),
            torch.from_numpy(sign_a).to(card, torch.int8),
            torch.from_numpy(mag_b).to(card, torch.int16),
            torch.from_numpy(sign_b).to(card, torch.int8))


def _run_twice(kernel, plain, args, **kw):
    got, again, want = kernel(*args, **kw), kernel(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    return got, again, want


# (M, K, N, kind): every M of the serve and train paths, a ragged K and N,
# the main projections, and every magnitude at 2^n - 1 with mixed signs
APPROX_GEMM_SHAPES = [
    (1, 301, 70, "random"), (4, 301, 70, "random"), (32, 301, 70, "random"),
    (33, 301, 70, "random"), (128, 301, 70, "random"), (1024, 301, 70, "random"),
    (4, 1024, 3072, "random"), (4, 3072, 1024, "random"), (128, 1024, 3072, "random"),
    (4, 3072, 1024, "extreme"), (33, 1024, 256, "extreme"),
    # granite-moe-1b-a400m's expert GEMMs (balanced tier): M = 1 (decode) and
    # 40 (pool prefill) on up/gate (1024, 512) and down (512, 1024)
    (1, 1024, 512, "random"), (40, 1024, 512, "random"), (1, 512, 1024, "random"),
    (40, 512, 1024, "random"),
    # mamba2-130m's in_proj (768 -> 3352: N not a multiple of 16) and out_proj
    (4, 768, 3352, "random"), (128, 768, 3352, "random"), (4, 1536, 768, "random"),
]


@pytest.mark.parametrize("m,k,n_cols,kind", APPROX_GEMM_SHAPES)
@pytest.mark.parametrize("kernel", ["lut_matmul", "seqmul_matmul"])
def test_approx_gemms_bitmatch_and_repeat(kernel, m, k, n_cols, kind, card):
    """Bit-equal to the plain version and bit-identical over two launches
    (split K where the plan splits) at n = 8, t = 4."""
    from repro_torch.engine import artifacts
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import seqmul_matmul as sm

    args = _sign_magnitude(m, k, n_cols, 8, m * 7 + k, card, kind)
    if kernel == "lut_matmul":
        lut = artifacts.product_lut_u16(8, 4, True, card)
        args = (lut, args[0].to(torch.uint8), args[1], args[2].to(torch.uint8), args[3])
        got, again, want = _run_twice(lm.lut_matmul, lm.lut_matmul_plain, args, n=8)
    else:
        got, again, want = _run_twice(sm.seqmul_matmul, sm.seqmul_matmul_plain, args, n=8, t=4)
    assert torch.equal(got, want)
    assert torch.equal(_bits(got), _bits(again))


@pytest.mark.parametrize("n", range(1, 13))
def test_seqmul_matmul_every_split_bitmatches(n, card):
    """Every t at this n, approximate with and without fix_to_1 and exact,
    at a ragged shape split over K; every magnitude at 2^n - 1 with mixed
    signs; at n = 12 also K = 3072 (int64 sums)."""
    from repro_torch.kernels import seqmul_matmul as sm

    cases = [(4, 301, 70, "random"), (33, 301, 70, "random"), (4, 301, 70, "extreme")]
    if n == 12:
        cases += [(4, 3072, 1024, "random"), (128, 3072, 256, "extreme")]
    for m, k, n_cols, kind in cases:
        args = _sign_magnitude(m, k, n_cols, n, n * 31 + m, card, kind)
        for t in range(1, max(1, n - 1) + 1):
            for approx, fix in ((True, True), (True, False), (False, False)):
                got, again, want = _run_twice(sm.seqmul_matmul, sm.seqmul_matmul_plain, args,
                                              n=n, t=t, approx=approx, fix_to_1=fix)
                where = (m, k, n_cols, kind, n, t, approx, fix)
                assert torch.equal(got, want), where
                assert torch.equal(_bits(got), _bits(again)), where


@pytest.mark.parametrize("n", [1, 4, 8])
def test_lut_matmul_every_width_bitmatches(n, card):
    """The table at n = 1, 4 and 8, magnitudes past 2^n - 1 clamped (uint8
    up to 255), ragged and split shapes, int64 sums past K * (2^(2n) - 1)
    >= 2^31 at n = 8."""
    from repro_torch.engine import artifacts
    from repro_torch.kernels import build
    from repro_torch.kernels import lut_matmul as lm

    lut = artifacts.product_lut_u16(n, max(1, n // 2), True, card)
    cases = [(4, 301, 70), (33, 1024, 512), (1, 64, 16)]
    if n == 8:
        cases.append((2, 33000, 64))
        assert build.wide_accumulator(33000, (1 << 16) - 1)
    for m, k, n_cols in cases:
        a, sa, b, sb = _sign_magnitude(m, k, n_cols, 8, m + k + n, card, "random")
        args = (lut, a.to(torch.uint8), sa, b.to(torch.uint8), sb)
        got, again, want = _run_twice(lm.lut_matmul, lm.lut_matmul_plain, args, n=n)
        assert torch.equal(got, want), (n, m, k, n_cols)
        assert torch.equal(_bits(got), _bits(again)), (n, m, k, n_cols)


@pytest.mark.parametrize("m,k,n_cols,kind", APPROX_GEMM_SHAPES)
def test_approx_gemm_launch_plans_are_the_kernels(m, k, n_cols, kind, card):
    """``launch_plan`` (grid, threads, shared memory), which the CPU tests
    read, equals the launch each built library makes for it."""
    from repro_torch.kernels import build
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import seqmul_matmul as sm

    sms = build.sm_count(card)
    for n in (1, 8, 12):
        plan = sm.launch_plan(m, k, n_cols, n, sms)
        assert (plan.grid, plan.threads, plan.smem) == sm.built_launch_plan(
            plan, m, k, n_cols, n, max(1, n - 1))
    for n in (1, 8):
        plan = lm.launch_plan(m, k, n_cols, n, sms)
        assert (plan.grid, plan.threads, plan.smem) == lm.built_launch_plan(
            plan, m, k, n_cols, n, sms)


def _attn_inputs(card, b, s, t, h, kv, hd, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g, device=card).to(dtype)
    k = torch.randn((b, t, kv, hd), generator=g, device=card).to(dtype)
    v = torch.randn((b, t, kv, hd), generator=g, device=card).to(dtype)
    k_pos = torch.arange(t, device=card).expand(b, t).clone()
    k_pos[0, t - t // 4:] = -1  # an unwritten tail in row 0
    q_pos = torch.arange(s, device=card).expand(b, s) + (t - s)
    q_pos = torch.minimum(q_pos, k_pos.amax(dim=1, keepdim=True))
    return q, k, v, q_pos, k_pos


def _flash_layout(card, layout, hd, dtype, seed):
    """q/k/v and positions of one forward layout, and (B, S, T, H, KV):
    "cache" S = 40 over T = 72 with row 0's tail unwritten; "left-pad"
    S = 72 over T = 200 (not a multiple of the key tile) with rows 1 and 2
    left-padded by 5 and 40 (their first queries see no slot) and a masked
    tail; "causal-200" S = T = 200; "group-16" the cache layout with 16
    query heads on one KV head; "group-7" with qwen2-vl-7b's 28 query heads
    over 4 KV heads (an item of 7 heads x 9 rows, 63 of its 64 row-heads);
    "group-2" with granite-moe-1b-a400m's 16 over 8; "train-g7" and
    "train-g2" their train shape, S = T = 128 causal, batch 8; "left-pad-g7"
    the left-pad layout with qwen2-vl's heads; "group-10" and "left-pad-g10"
    with recurrentgemma-2b's 10 query heads on one KV head (an item of 10
    heads x 6 rows, 60 of its 64 row-heads)."""
    heads = {"cache": (8, 2), "group-16": (16, 1), "group-7": (28, 4), "group-2": (16, 8),
             "group-10": (10, 1)}
    if layout in heads:
        h, kv = heads[layout]
        return (*_attn_inputs(card, 2, 40, 72, h, kv, hd, dtype, seed), (2, 40, 72, h, kv))
    b, s, t, h, kv = {"left-pad": (3, 72, 200, 8, 2), "left-pad-g7": (3, 72, 200, 28, 4),
                      "left-pad-g10": (3, 72, 200, 10, 1),
                      "causal-200": (2, 200, 200, 4, 2), "train-g7": (8, 128, 128, 28, 4),
                      "train-g2": (8, 128, 128, 16, 8)}[layout]
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g, device=card).to(dtype)
    k = torch.randn((b, t, kv, hd), generator=g, device=card).to(dtype)
    v = torch.randn((b, t, kv, hd), generator=g, device=card).to(dtype)
    jj = torch.arange(t, device=card).expand(b, t)
    if s == t:
        return q, k, v, jj[:, :s].int(), jj.int(), (b, s, t, h, kv)
    pad = torch.zeros((b, 1), dtype=torch.int64, device=card)
    pad[1], pad[2] = 5, 40
    q_pos = (torch.arange(s, device=card).expand(b, s) - pad).int()
    k_pos = torch.where((jj >= pad) & (jj < s), jj - pad, -1).int()
    return q, k, v, q_pos, k_pos, (b, s, t, h, kv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,window,softcap,layout", [
    (128, None, None, "cache"), (64, 24, None, "cache"), (16, None, 30.0, "cache"),
    (128, None, None, "left-pad"), (32, None, 30.0, "left-pad"), (128, None, None, "causal-200"),
    (64, 24, None, "causal-200"), (128, None, None, "group-16"), (16, 24, 30.0, "group-16"),
    (256, None, None, "cache"), (256, 24, 50.0, "left-pad"), (256, None, None, "causal-200"),
    (256, 24, None, "group-16"),
    # qwen2-vl-7b's g = 7 (28 / 4 of 128) and granite-moe-1b-a400m's head width 64, g = 2
    (128, None, None, "group-7"), (128, 24, 30.0, "group-7"), (128, None, None, "left-pad-g7"),
    (128, None, None, "train-g7"), (64, None, None, "group-2"), (64, None, None, "train-g2"),
    # recurrentgemma-2b's g = 10 (10 / 1 of 256, MQA)
    (256, None, None, "group-10"), (256, 24, None, "group-10"), (256, None, None, "left-pad-g10"),
])
def test_flash_attention_matches_plain_version(hd, window, softcap, layout, dtype, card):
    """The forward kernel against the plain version within 2e-5, over a
    masked tail, left-padded rows (which walk every key tile), S = T = 200
    causal and with a window (key tiles skipped), and 16 query heads per KV
    head; a second launch gives the same bits, and a third, counting on the
    card the (item, key tile) pairs it skips, skips those of
    ``fwd_tile_plan`` and gives the same bits."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, qp, kp, (b, s, t, h, kv) = _flash_layout(card, layout, hd, dtype, seed=hd)
    kw = dict(causal=True, window=window, softcap=softcap, scale=hd**-0.5)
    got = fa.flash_attention(q, k, v, qp, kp, **kw)
    want = fa.flash_attention_plain(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, fa.flash_attention(q, k, v, qp, kp, **kw))
    plan = fa.launch_plan("fwd", b, s, t, h, kv, hd, dtype,
                          sms=torch.cuda.get_device_properties(card).multi_processor_count)
    live = fa.fwd_tile_plan(qp, kp, rows=plan.rows, keys=plan.keys, causal=True, window=window)
    counter = torch.zeros(1, dtype=torch.int32, device=card)
    counted, _ = fa.launch_forward(q, k, v, qp, kp, skipped=counter, **kw)
    assert torch.equal(counted, got)
    assert counter.item() == int((~live).sum()) * kv * -(-(h // kv) // plan.heads)
    if layout == "causal-200":
        assert not bool(live.all())


def _encoder_inputs(card, b, s, h, kv, hd, dtype, seed):
    """q/k/v over S = T with every slot written at positions 0..S-1, as an
    encoder's self-attention reads its frames."""
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g, device=card).to(dtype)
    k = torch.randn((b, s, kv, hd), generator=g, device=card).to(dtype)
    v = torch.randn((b, s, kv, hd), generator=g, device=card).to(dtype)
    pos = torch.arange(s, device=card, dtype=torch.int32).expand(b, s).contiguous()
    return q, k, v, pos, pos.clone()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (4, 32, 16, 16, 64, None), (8, 128, 16, 16, 64, None), (1, 1024, 16, 16, 64, None),
    (2, 200, 16, 16, 64, 24), (2, 200, 8, 2, 128, None), (2, 72, 10, 1, 256, None),
], ids=["seamless-serve", "seamless-train", "seamless-long", "ragged-window", "g4-ragged",
        "g10"])
def test_flash_attention_non_causal_matches_plain_version(b, s, h, kv, hd, window, dtype, card):
    """The forward kernel with ``causal=False`` (an encoder's self-attention:
    every query reads every slot, or those of its window both ways) against
    the plain version within 2e-5, o and lse; a second launch gives the same
    bits, and a launch counting on the card the pairs it skips skips those
    of ``fwd_tile_plan`` (none without a window)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, qp, kp = _encoder_inputs(card, b, s, h, kv, hd, dtype, seed=s + hd)
    kw = dict(causal=False, window=window, softcap=None, scale=hd**-0.5)
    got, lse = fa.flash_attention_fwd(q, k, v, qp, kp, **kw, with_lse=True)
    want, want_lse = fa.attend(q, k, v, qp, kp, **kw, with_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
    again, lse2 = fa.flash_attention_fwd(q, k, v, qp, kp, **kw, with_lse=True)
    assert torch.equal(got, again) and torch.equal(lse, lse2)
    plan = fa.launch_plan("fwd", b, s, s, h, kv, hd, dtype,
                          sms=torch.cuda.get_device_properties(card).multi_processor_count)
    live = fa.fwd_tile_plan(qp, kp, rows=plan.rows, keys=plan.keys, causal=False, window=window)
    counter = torch.zeros(1, dtype=torch.int32, device=card)
    counted, _ = fa.launch_forward(q, k, v, qp, kp, skipped=counter, **kw)
    assert torch.equal(counted, got)
    assert counter.item() == int((~live).sum()) * kv * -(-(h // kv) // plan.heads)
    assert bool(live.all()) == (window is None)


@pytest.mark.parametrize("mode,b,s,bk", [("bitexact", 4, 32, 32), ("bitexact", 1, 1024, 64),
                                         ("lowrank", 4, 32, 32), ("lowrank", 1, 1024, 128)])
def test_approx_attention_non_causal_matches_plain_version(mode, b, s, bk, card):
    """The approximate attention with ``causal=False`` at seamless-m4t-large-v2's
    16 / 16 heads of 64, the encoder's serve shape and S = T = 1024: within
    one probability quantum and 1e-5 for 99% of the outputs, two launches
    bit-identical, the pairs skipped on the card those of
    ``approx_tile_plan``."""
    from repro_torch.kernels import approx_attention as aa

    q, k, v, qp, kp = _encoder_inputs(card, b, s, 16, 16, 64, torch.bfloat16, seed=s)
    kw = dict(mode=mode, n=8, t=4, rank=8, causal=False, window=None, softcap=None,
              scale=64**-0.5, bk=bk)
    got = aa.approx_flash_attention(q, k, v, qp, kp, **kw)
    want = aa.approx_attention_plain(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert err.max().item() <= v.float().abs().max().item() / 255
    assert (err <= 1e-5).float().mean().item() >= 0.99
    assert torch.equal(got, aa.approx_flash_attention(q, k, v, qp, kp, **kw))
    ops = aa.kernel_operands(q, k, v, mode=mode, n=8, t=4, fix_to_1=True, rank=8)
    plan = aa.launch_plan(mode, b, s, s, 16, 16, 64, 8, 8,
                          torch.cuda.get_device_properties(card).multi_processor_count)
    live = aa.approx_tile_plan(qp, kp, bk=bk, rows=plan.rows, causal=False, window=None)
    counter = torch.zeros(1, dtype=torch.int32, device=card)
    counted = aa.launch_kernel(ops, qp, kp, bk=bk, causal=False, window=None, softcap=None,
                               scale=64**-0.5, skipped=counter)
    assert torch.equal(counted, got)
    assert counter.item() == int((~live).sum()) * 16 * -(-1 // plan.heads) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,h,kv,t,window,softcap,empty_row", [
    (128, 16, 8, 100, None, None, False), (128, 8, 1, 100, 20, None, False),
    (128, 4, 4, 100, None, 30.0, False), (128, 16, 1, 100, None, None, False),
    (128, 16, 8, 100, None, None, True), (128, 8, 2, 100, 24, 30.0, True),
    (128, 16, 8, 2000, None, None, False), (128, 16, 1, 2000, 300, None, False),
    (256, 16, 8, 100, None, None, True), (256, 16, 16, 100, 20, 50.0, True),
    (256, 16, 8, 8192, 4096, 50.0, True), (256, 16, 1, 2000, None, None, True),
    # qwen2-vl-7b's g = 7 (28 / 4 of 128); granite-moe-1b-a400m's 16 / 8 of 64
    (128, 28, 4, 100, None, None, True), (128, 28, 4, 2000, None, None, False),
    (128, 28, 4, 4096, 300, None, True), (64, 16, 8, 100, None, None, True),
    (64, 16, 8, 2000, 24, 30.0, False),
    # recurrentgemma-2b's g = 10 (10 / 1 of 256); its window of 2,048 over 4,096 slots
    (256, 10, 1, 100, None, None, True), (256, 10, 1, 2000, None, None, False),
    (256, 10, 1, 4096, 2048, None, True),
    # seamless-m4t-large-v2's decoder: g = 1 at head width 64
    (64, 16, 16, 100, None, None, True), (64, 16, 16, 4096, None, None, False),
])
def test_flash_decode_matches_plain_version(hd, h, kv, t, window, softcap, empty_row, dtype,
                                            card):
    """The decode kernel against the plain version within 2e-5, over 100
    slots, with a row whose position allows no slot (``empty_row``: the
    uniform average of all T slots), and over 2,000 slots (chunks of the
    cache split across blocks), 16 query heads per KV head included; at
    gemma's head width 256 too (gemma2-9b's 16 / 8 heads, gemma-7b's 16 /
    16, and gemma2's own window of 4,096 over 8,192 slots, whose dead
    chunks are skipped); a second launch gives the same bits, the launch
    plan is the built library's, and a third launch, counting on the card
    the chunks it skips, skips those of ``decode_chunk_plan``."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _, kp = _attn_inputs(card, 3, 1, t, h, kv, hd, dtype,
                                  seed=h + kv if hd == 128 else t + kv)
    qp = kp.amax(dim=1)
    if empty_row:
        qp[1] = -1  # before every written slot: nothing is allowed
    kw = dict(window=window, softcap=softcap, scale=hd**-0.5)
    got = fa.flash_decode(q[:, 0], k, v, qp, kp, **kw)
    want = fa.flash_decode_plain(q[:, 0], k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, fa.flash_decode(q[:, 0], k, v, qp, kp, **kw))
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = fa.launch_plan("decode", 3, 1, t, h, kv, hd, dtype, sms=sms)
    assert plan == fa.built_launch_plan("decode", 3, 1, t, h, kv, hd, dtype, sms=sms)
    live = fa.decode_chunk_plan(qp, kp, chunk=plan.keys, window=window)
    counter = torch.zeros(1, dtype=torch.int32, device=card)
    counted = fa.launch_decode(q[:, 0], k, v, qp, kp, skipped=counter, **kw)
    assert torch.equal(counted, got)
    assert counter.item() == int((~live).sum()) * kv
    if empty_row:
        assert not bool(live[1].any())
        torch.testing.assert_close(got[1], v[1].float().mean(0).repeat_interleave(h // kv, 0),
                                   rtol=2e-5, atol=2e-5)
    if window is not None and t >= 2 * window:  # the oldest chunks are out of the window
        assert not bool(live[0].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_flash_forward_launch_plan_is_the_kernels(hd, dtype, card):
    """``launch_plan`` and ``smem_bytes`` for "fwd" and "decode", which the
    CPU tests read, equal the launch that the built library makes, at the
    serve, train and long shapes, S = T = 200 and groups of 1 to 16."""
    from repro_torch.kernels import flash_attention as fa

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for b, s, t, h, kv in ((4, 32, 48, 16, 8), (8, 128, 128, 16, 8), (1, 1024, 1024, 16, 8),
                           (1, 4096, 4096, 16, 8), (2, 200, 200, 4, 2), (3, 72, 256, 16, 1),
                           (2, 3, 7, 64, 1), (4, 32, 48, 28, 4), (8, 128, 128, 28, 4),
                           (1, 1024, 1024, 28, 4), (4, 1, 4096, 28, 4), (4, 32, 48, 10, 1),
                           (1, 4096, 4096, 10, 1), (4, 1, 4096, 10, 1)):
        for kernel in ("fwd", "decode"):
            if kernel == "decode" and h // kv > fa.MAX_GROUP:
                continue
            plan = fa.launch_plan(kernel, b, s, t, h, kv, hd, dtype, sms=sms)
            assert plan == fa.built_launch_plan(kernel, b, s, t, h, kv, hd, dtype, sms=sms), \
                (kernel, b, s, t, h, kv)
            items = b * kv * -(-s // plan.rows) * -(-(h // kv) // plan.heads)
            assert plan.smem == fa.smem_bytes(kernel, hd, dtype, s, t, h // kv, items, sms)


@pytest.mark.parametrize("mode,bk,window,softcap", [("bitexact", 16, None, None),
                                                     ("bitexact", 64, 24, 30.0),
                                                     ("lowrank", 16, 24, None),
                                                     ("lowrank", 128, None, 30.0)])
def test_approx_attention_matches_plain_version(mode, bk, window, softcap, card):
    from repro_torch.kernels import approx_attention as aa

    q, k, v, qp, kp = _attn_inputs(card, 2, 40, 128, 16, 8, 128, torch.bfloat16, seed=bk)
    kw = dict(mode=mode, n=8, t=4, rank=8, causal=True, window=window, softcap=softcap,
              scale=128**-0.5, bk=bk)
    got = aa.approx_flash_attention(q, k, v, qp, kp, **kw)
    want = aa.approx_attention_plain(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert err.max().item() <= v.float().abs().max().item() / 255
    assert (err <= 1e-5).float().mean().item() >= 0.99


def _padded_cache(card, b, s, t, h, kv, hd, seed):
    """bf16 q/k/v over a cache of t slots: row 1 left-padded by 5 (its first
    queries see no slot), row 2 by 40, every row's slots past its prompt of
    s an unwritten tail."""
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g, device=card).to(torch.bfloat16)
    k = torch.randn((b, t, kv, hd), generator=g, device=card).to(torch.bfloat16)
    v = torch.randn((b, t, kv, hd), generator=g, device=card).to(torch.bfloat16)
    pad = torch.zeros((b, 1), dtype=torch.int64, device=card)
    pad[1], pad[2] = 5, 40
    jj = torch.arange(t, device=card).expand(b, t)
    q_pos = (torch.arange(s, device=card).expand(b, s) - pad).to(torch.int32)
    k_pos = torch.where((jj >= pad) & (jj < s), jj - pad, -1).to(torch.int32)
    return q, k, v, q_pos, k_pos


@pytest.mark.parametrize("mode,hd,n,rank,bk,window,softcap,h,kv", [
    ("bitexact", 16, 8, 8, 16, None, None, 8, 2), ("bitexact", 64, 4, 8, 64, 24, 30.0, 8, 2),
    ("bitexact", 128, 8, 8, 128, None, None, 8, 2), ("bitexact", 32, 8, 8, 40, None, 30.0, 8, 2),
    ("lowrank", 16, 8, 4, 8, None, 30.0, 8, 2), ("lowrank", 64, 8, 24, 128, 24, None, 8, 2),
    ("lowrank", 128, 4, 8, 64, None, None, 8, 2), ("lowrank", 32, 8, 1, 100, None, None, 8, 2),
    ("bitexact", 256, 8, 8, 64, 24, 50.0, 8, 2), ("bitexact", 256, 8, 8, 16, None, None, 8, 2),
    ("lowrank", 256, 8, 8, 128, None, None, 8, 2), ("lowrank", 256, 8, 8, 16, 24, 50.0, 8, 2),
    # qwen2-vl-7b's g = 7 (28 / 4 of 128): bitexact's items of 64 row-heads
    # hold 7 x 9, lowrank's of 32 hold 7 x 4
    ("bitexact", 128, 8, 8, 16, None, None, 28, 4), ("bitexact", 128, 8, 8, 64, 24, None, 28, 4),
    ("lowrank", 128, 8, 8, 16, None, None, 28, 4), ("lowrank", 128, 8, 8, 128, None, 30.0, 28, 4),
    # granite-moe-1b-a400m's 16 / 8 of 64
    ("bitexact", 64, 8, 8, 16, None, None, 16, 8), ("lowrank", 64, 8, 8, 16, None, None, 16, 8),
    # recurrentgemma-2b's g = 10 (10 / 1 of 256)
    ("bitexact", 256, 8, 8, 16, None, None, 10, 1), ("bitexact", 256, 8, 8, 64, 24, None, 10, 1),
])
def test_approx_attention_redesign_matches_plain_version(mode, hd, n, rank, bk, window, softcap,
                                                         h, kv, card):
    """Left pads and a masked tail over T = 256 (pairs the kernels skip, and
    tiles that must walk every block), at every head width, n = 4, ranks 1
    and 24, ragged key blocks, and query groups of 4, 7 and 2: within one
    probability quantum max|v| / (2^n - 1), 99% within 1e-5, lse within
    1e-5; two launches give the same bits, and a third, counting on the
    card the pairs it skips, skips the pairs of ``approx_tile_plan`` (some,
    not all) and gives the same bits."""
    from repro_torch.kernels import approx_attention as aa

    b, s, t = 3, 72, 256
    q, k, v, qp, kp = _padded_cache(card, b, s, t, h, kv, hd, seed=hd + n + rank)
    kw = dict(causal=True, window=window, softcap=softcap, scale=hd**-0.5)
    ops = aa.kernel_operands(q, k, v, mode=mode, n=n, t=n // 2, fix_to_1=True, rank=rank)
    got, again = (aa.launch_kernel(ops, qp, kp, bk=bk, with_lse=True, **kw) for _ in range(2))
    want, want_lse = aa.approx_attention_plain(q, k, v, qp, kp, mode=mode, n=n, t=n // 2,
                                               rank=rank, bk=bk, with_lse=True, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a.view(torch.int32), b_.view(torch.int32))
               for a, b_ in zip(got, again))
    err = (got[0] - want).abs()
    assert bool(torch.isfinite(got[0]).all())
    assert err.max().item() <= v.float().abs().max().item() / ((1 << n) - 1)
    assert (err <= 1e-5).float().mean().item() >= 0.99
    assert (got[1] - want_lse).abs().max().item() <= 1e-5
    plan = aa.launch_plan(mode, b, s, t, h, kv, hd, n, rank, torch.cuda.get_device_properties(
        card).multi_processor_count)
    live = aa.approx_tile_plan(qp, kp, bk=bk, rows=plan.rows, causal=True, window=window)
    assert not bool(live.all())
    counter = torch.zeros(1, dtype=torch.int32, device=card)
    counted = aa.launch_kernel(ops, qp, kp, bk=bk, with_lse=True, skipped=counter, **kw)
    assert all(torch.equal(a.view(torch.int32), b_.view(torch.int32))
               for a, b_ in zip(got, counted))
    assert counter.item() == int((~live).sum()) * kv * -(-(h // kv) // plan.heads)


@pytest.mark.parametrize("mode", ["bitexact", "lowrank"])
def test_approx_attention_launch_plan_is_the_kernels(mode, card):
    """``launch_plan`` (which the CPU tests read) equals the launch that the
    built library makes, at the serve, train and long shapes, every head
    width, n = 4 and 8, ranks 1, 8 and 24, and a group wider than an item;
    where the block does not fit (lowrank rank 24 at head width 256) both
    refuse the launch."""
    from repro_torch.kernels import approx_attention as aa

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    shapes = [(4, 32, 48, 16, 8), (8, 128, 128, 16, 8), (1, 1024, 1024, 16, 8),
              (3, 72, 256, 8, 2), (2, 3, 7, 64, 1), (1, 10, 10, 6, 2), (4, 32, 48, 28, 4),
              (1, 1024, 1024, 28, 4), (4, 32, 48, 10, 1)]
    for b, s, t, h, kv in shapes:
        for hd in (16, 32, 64, 128, 256):
            for n, rank in ((8, 8), (4, 1), (8, 24)):
                if mode == "lowrank" and hd == 256 and rank == 24:
                    for plan_of in (aa.launch_plan, aa.built_launch_plan):
                        with pytest.raises(ValueError):
                            plan_of(mode, b, s, t, h, kv, hd, n, rank, sms)
                    continue
                plan = aa.launch_plan(mode, b, s, t, h, kv, hd, n, rank, sms)
                assert plan == aa.built_launch_plan(mode, b, s, t, h, kv, hd, n, rank, sms), \
                    (b, s, t, h, kv, hd, n, rank)


def _bwd_inputs(card, b, s, h, kv, hd, dtype, seed, pad=0):
    """q/k/v over s causal positions, row 1 left-padded by ``pad`` (its pad
    queries have no allowed slot), and a float32 output cotangent."""
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g, device=card).to(dtype)
    k = torch.randn((b, s, kv, hd), generator=g, device=card).to(dtype)
    v = torch.randn((b, s, kv, hd), generator=g, device=card).to(dtype)
    do = torch.randn((b, s, h, hd), generator=g, device=card)
    shift = torch.zeros((b, 1), dtype=torch.int64, device=card)
    shift[1] = pad
    jj = torch.arange(s, device=card).expand(b, s)
    q_pos = (jj - shift).to(torch.int32)
    k_pos = torch.where(jj >= shift, jj - shift, -1).to(torch.int32)
    return q, k, v, q_pos, k_pos, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,kv,hd,window,softcap,pad,s,causal", [
    (16, 8, 128, None, None, 0, 72, True), (8, 2, 64, 24, 30.0, 0, 72, True),
    (4, 4, 16, None, None, 5, 72, True), (16, 8, 128, None, None, 0, 200, True),
    (4, 2, 32, 24, None, 0, 200, False),
    # head width 256: gemma2-9b's heads (16 / 8) plain, window + softcap and a
    # pad row, ragged tiles; gemma-7b's 16 / 16
    (16, 8, 256, None, None, 0, 72, True), (16, 8, 256, 24, 50.0, 5, 200, True),
    (16, 16, 256, None, None, 0, 200, True),
    # qwen2-vl-7b's g = 7 (28 / 4 of 128) at its train shape's length, and
    # with a window, softcap and pad row; granite-moe-1b-a400m's 16 / 8 of 64
    (28, 4, 128, None, None, 0, 128, True), (28, 4, 128, 24, 30.0, 5, 200, True),
    (16, 8, 64, None, None, 0, 128, True), (16, 8, 64, None, None, 3, 200, True),
    # seamless-m4t-large-v2's 16 / 16 of 64: its encoder (non-causal) and
    # decoder (causal) at the train shape's length, and non-causal ragged
    # under a window (tiles skipped both ways)
    (16, 16, 64, None, None, 0, 128, False), (16, 16, 64, None, None, 0, 128, True),
    (16, 16, 64, 24, None, 0, 200, False),
    # recurrentgemma-2b's g = 10 (10 / 1 of 256) at the train shape's length
    # under its window, and with a binding window and a pad row
    (10, 1, 256, 2048, None, 0, 128, True), (10, 1, 256, 24, None, 5, 200, True),
])
def test_flash_backward_kernels_match_plain_version(h, kv, hd, window, softcap, pad, s, causal,
                                                    dtype, card):
    """dq and dk/dv against ``flash_attention_bwd_plain`` on the forward
    kernel's (o, lse), float32 before the cast: within 1e-4 * max|want| per
    output (bf16 tensor-core products of split float32 operands, float32
    sums in another order), the fully masked pad rows too; a second launch
    gives the same bits.  S = T = 200 has partial tiles and tiles the
    kernels skip (causally masked, or out of the window)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, qp, kp, do = _bwd_inputs(card, 2, s, h, kv, hd, dtype, seed=h + hd, pad=pad)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=hd**-0.5)
    o, lse = fa.flash_attention_fwd(q, k, v, qp, kp, **kw, with_lse=True)
    _, want_lse = fa.attend(q, k, v, qp, kp, **kw, with_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
    dd = torch.einsum("bshd,bshd->bhs", do, o)
    launch = lambda: (fa.flash_attention_bwd_dq(q, k, v, qp, kp, do, lse, dd, **kw),
                      *fa.flash_attention_bwd_dkv(q, k, v, qp, kp, do, lse, dd, **kw))
    got, again = launch(), launch()
    want = fa.flash_attention_bwd_plain(q, k, v, qp, kp, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name, a, a2, b_ in zip(("dq", "dk", "dv"), got, again, want):
        err = (a - b_).abs().max().item()
        assert err <= 1e-4 * b_.abs().max().item(), (name, err)
        assert torch.equal(a, a2), name
    if pad:
        assert bool((got[0][1, :pad] == 0).all())
    if s > 128:
        dq_live, dkv_live = fa.bwd_tile_plan(qp, kp, lse, causal=causal, window=window)
        assert not bool(dq_live.all()) and not bool(dkv_live.all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_flash_backward_launch_plan_is_the_kernels(hd, dtype, card):
    """``launch_plan`` and ``smem_bytes``, which the CPU tests read, equal
    the grid, block and shared memory that the built library launches
    with, at the train shape, S = T = 1024, the serve cache and S = T = 200."""
    from repro_torch.kernels import flash_attention as fa

    for b, s, t, h, kv in ((8, 128, 128, 16, 8), (1, 1024, 1024, 16, 8), (4, 32, 48, 16, 8),
                           (2, 200, 200, 4, 2), (8, 128, 128, 28, 4), (1, 1024, 1024, 28, 4)):
        for kernel in ("dq", "dkv"):
            plan = fa.launch_plan(kernel, b, s, t, h, kv, hd, dtype)
            assert plan == fa.built_launch_plan(kernel, b, s, t, h, kv, hd, dtype), \
                (kernel, b, s, t, h, kv)
            assert plan.smem == fa.smem_bytes(kernel, hd, dtype, s, t, h // kv)


@pytest.mark.parametrize("mode", ["bitexact", "lowrank"])
def test_approx_attention_backward_runs_on_its_residuals(mode, card):
    """Straight-through: autograd of approx_flash_attention on the card is
    the dq and dk/dv kernels on the approximate kernel's (o, lse)."""
    from repro_torch.kernels import approx_attention as aa
    from repro_torch.kernels import flash_attention as fa

    q, k, v, qp, kp, do = _bwd_inputs(card, 2, 64, 16, 8, 128, torch.bfloat16, seed=9, pad=3)
    kw = dict(causal=True, window=None, softcap=None, scale=128**-0.5)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = (fa.DQ_KERNEL.launches, fa.DKV_KERNEL.launches)
    out = aa.approx_flash_attention(*leaves, qp, kp, mode, 8, 4, True, 8, bk=64, **kw)
    out.backward(do)
    assert (fa.DQ_KERNEL.launches, fa.DKV_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    ops = aa.kernel_operands(q, k, v, mode=mode, n=8, t=4, fix_to_1=True, rank=8)
    o, lse = aa.launch_kernel(ops, qp, kp, bk=64, with_lse=True, **kw)
    assert torch.equal(o, out.detach())
    want = fa.flash_attention_bwd_plain(q, k, v, qp, kp, o, lse, do, **kw)
    torch.cuda.synchronize()
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16 and bool(torch.isfinite(leaf.grad).all())
        err = (leaf.grad.float() - w).abs().max().item()
        # the kernels' float32 result, then one bf16 rounding
        assert err <= 1e-4 * w.abs().max().item() + w.abs().max().item() * 2.0**-8


def test_full_width_train_step_is_finite(card):
    """One step of full-width paper-multiplier with the pallas attention:
    lut_matmul forward, the flash forward with lse, dq and dk/dv."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config("paper-multiplier"), attn_impl="pallas")
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=4, warmup_steps=1)
    state = init_train_state(model, tcfg, 0, device=card)
    toks = torch.randint(0, cfg.vocab_size, (2, 129), device=card,
                         generator=torch.Generator(device=card).manual_seed(0))
    kernels.reset_launch_counts()
    state, metrics = make_train_step(model, tcfg)(
        state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0
    for name in ("lut_matmul", "flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert counts[name] > 0, counts
    assert all(bool(torch.isfinite(m).all()) for m in state.opt.mu)
    assert isinstance(state.opt, adamw.OptState)


@pytest.mark.parametrize("tier,kernel", [("exact", None), ("balanced", "lut_matmul"),
                                         ("draft", "packed_matmul")])
def test_moe_ffn_is_bit_identical_over_two_launches(tier, kernel, card):
    """granite-moe-1b-a400m's expert layer at its published widths (32
    experts, top-8, ``moe_d_ff`` 512, d_model 1024, bf16) over a pool
    prefill's 4 x 32 tokens, at capacity 40: two launches on the same
    inputs give the same bits, since the combine adds each token's rows in
    a fixed order (no atomics); at ``balanced`` and ``draft`` the expert
    GEMMs run ``lut_matmul`` / ``packed_matmul``, one launch per expert and
    projection (``draft``'s noise drawn from a generator seeded alike)."""
    from repro_torch import kernels
    from repro_torch.configs.registry import apply_quality, get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import Ctx

    cfg = get_config("granite-moe-1b-a400m")
    if tier != "exact":
        cfg = apply_quality(cfg, tier)
    g = torch.Generator(device=card).manual_seed(0)
    params = moe.init_moe(cfg, torch.bfloat16, card, g)
    x = torch.randn((4, 32, cfg.d_model), generator=g, device=card).to(torch.bfloat16)

    def run():
        ctx = Ctx(cfg=cfg, generator=torch.Generator(device=card).manual_seed(1))
        with torch.inference_mode():
            return moe.moe_ffn(params, x, ctx)

    kernels.reset_launch_counts()
    (out, aux), (again, aux2) = run(), run()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))
    assert torch.equal(aux, aux2)
    r = moe.route(params["router"], x.reshape(-1, cfg.d_model), cfg)
    assert r.cap == 40
    if kernel is not None:
        assert counts[kernel] == 2 * 3 * cfg.num_experts, counts
    assert sum(counts.values()) == (0 if kernel is None else counts[kernel])


def _u32_operands(shape, n, seed, card):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(0, 1 << n, shape, dtype=np.uint64)
                                  .astype(np.uint32)).to(card) for _ in range(2))


def _same_bits(got, want) -> bool:
    return got.dtype == want.dtype == torch.uint32 and bool(torch.equal(got, want))


@pytest.mark.parametrize("shape", [(), (0,), (1,), (127,), (129,), ((1 << 20) + 3,),
                                   (4096, 4096)], ids=str)
def test_seqmul_kernels_bitmatch_plain_versions(shape, card):
    """Both elementwise kernels at the smoke's sizes: ragged, 0-d, empty and
    2^24 elements, packed at n = 12 and words at the paper's n = 16."""
    from repro_torch.kernels import seqmul_kernel as sk

    a, b = _u32_operands(shape, 12, 1, card)
    got = sk.seqmul_packed(a, b, n=12, t=6)
    want = sk.seqmul_packed_plain(a, b, n=12, t=6)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    a, b = _u32_operands(shape, 16, 2, card)
    got = sk.seqmul_words(a, b, n=16, t=8)
    want = sk.seqmul_words_plain(a, b, n=16, t=8)
    torch.cuda.synchronize()
    assert all(_same_bits(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n", [1, 4, 8, 12, 15, 16])
def test_seqmul_kernels_bitmatch_plain_versions_over_splits(n, card):
    """Every kernel variant (exact, approximate with and without fix_to_1)
    at three splits, on int64 operands and on an unaligned uint32 view."""
    from repro_torch.kernels import seqmul_kernel as sk

    a, b = _u32_operands((1 << 16) + 5, n, n, card)
    wide = (a.long(), b.long())
    for t in sorted({1, max(1, n // 2), max(1, n - 1)}):
        for approx, fix in ((True, True), (True, False), (False, False)):
            kw = dict(n=n, t=t, approx=approx, fix_to_1=fix)
            for x, y in ((a, b), (a[1:], b[1:]), wide):
                low, high = sk.seqmul_words(x, y, **kw)
                want_low, want_high = sk.seqmul_words_plain(x, y, **kw)
                assert _same_bits(low, want_low) and _same_bits(high, want_high), kw
                if 2 * n <= 31:
                    assert _same_bits(sk.seqmul_packed(x, y, **kw),
                                      sk.seqmul_packed_plain(x, y, **kw)), kw


def test_seqmul_launch_counts_and_engine_multiply(card):
    """One launch per call that has elements, none for an empty one or a CPU
    tensor; ``engine.multiply`` (auto) and ``ops.approx_multiply`` run the
    packed kernel and agree with the reference body."""
    from repro_torch import engine, kernels
    from repro_torch.kernels import ops
    from repro_torch.kernels import seqmul_kernel as sk

    a, b = _u32_operands((8, 128), 8, 3, card)
    kernels.reset_launch_counts()
    got = engine.multiply(a, b, n=8, t=4)
    shim = ops.approx_multiply(a, b)
    sk.seqmul_words(a, b, n=8, t=4)
    sk.seqmul_packed(a[:0], b[:0], n=8, t=4)
    sk.seqmul_words(a.cpu(), b.cpu(), n=8, t=4)
    counts = kernels.launch_counts()
    assert counts["seqmul_packed"] == 2 and counts["seqmul_words"] == 1, counts
    want = engine.multiply(a, b, n=8, t=4, backend="reference")
    assert _same_bits(got, want) and _same_bits(shim, want)
    assert _same_bits(want.cpu(), engine.multiply(a.cpu(), b.cpu(), n=8, t=4))


def test_engine_multiply_with_one_operand_on_the_card(card):
    """An array-like beside a CUDA tensor joins it on the card and launches
    the packed kernel; a CPU tensor beside a CUDA tensor raises."""
    from repro_torch import engine, kernels

    a, b = _u32_operands((1000,), 8, 4, card)
    want = engine.multiply(a, b, n=8, t=4, backend="reference")
    for x, y in ((a.cpu().numpy(), b), (a, b.cpu().numpy())):
        kernels.reset_launch_counts()
        got = engine.multiply(x, y, n=8, t=4)
        assert kernels.launch_counts()["seqmul_packed"] == 1
        assert got.device == a.device and _same_bits(got, want)
    for x, y in ((a.cpu(), b), (a, b.cpu())):
        with pytest.raises(ValueError, match="cpu"):
            engine.multiply(x, y, n=8, t=4)


def test_error_analysis_on_the_card_equals_the_cpu(card):
    """``exhaustive_eval`` and ``mc_eval`` on the card report what the CPU
    reports, field for field; up to n = 16 the card's products come from
    the ``seqmul_words`` kernel."""
    from repro_torch import kernels
    from repro_torch.core import error_metrics

    for kw in (dict(n=1, t=1), dict(n=8, t=4), dict(n=8, t=3, fix_to_1=False)):
        kernels.reset_launch_counts()
        assert (error_metrics.exhaustive_eval(**kw, device=card)
                == error_metrics.exhaustive_eval(**kw, device="cpu"))
        assert kernels.launch_counts()["seqmul_words"] == 1  # one chunk
    for n, t in ((16, 8), (32, 16)):
        kw = dict(samples=1 << 16, seed=n)
        assert (error_metrics.mc_eval(n, t, device=card, **kw)
                == error_metrics.mc_eval(n, t, device="cpu", **kw))


@pytest.fixture
def nccl_mesh(card, tmp_path):
    """A one-rank NCCL process group (a FileStore, no network) and its
    ("data",) mesh on the card, torn down after the test."""
    from torch.distributed.device_mesh import init_device_mesh

    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    torch.distributed.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("tier,kernel", [("exact", None), ("balanced", "lut_matmul"),
                                         ("draft", "packed_matmul")])
def test_one_rank_nccl_mesh_serves_the_unsharded_streams(tier, kernel, nccl_mesh):
    """Reduced qwen3-0.6b on the card under a one-rank ('data',) NCCL mesh:
    the streams equal ``mesh=None``'s, through the tier's GEMM kernel."""
    from repro_torch import kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import data_parallel_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ContinuousScheduler, synth_requests

    assert data_parallel_mesh(4) is None  # one rank: nothing to split
    cfg = get_config("qwen3-0.6b").reduced()
    model = build_model(cfg)
    params = model.init_params(0, device="cuda")
    queue = synth_requests(6, prompt_len=8, gen=4, vocab_size=cfg.vocab_size, seed=0)
    runs = []
    for mesh in (None, nccl_mesh):
        kernels.reset_launch_counts()
        runs.append(ContinuousScheduler(model, params, batch_size=4, prompt_len=8, max_new=4,
                                        quality=tier, mesh=mesh).run(queue))
        if kernel is not None:
            assert kernels.launch_counts()[kernel] > 0
    for r in queue:
        np.testing.assert_array_equal(runs[0].outputs[r.id], runs[1].outputs[r.id])


def test_elastic_checkpoint_on_the_card_restores_on_card_and_cpu(nccl_mesh, tmp_path):
    """A reduced train state on the card, sharded over a one-rank (1, 1)
    mesh, saved, restored onto the card (sharded) and onto the CPU
    (unsharded): bit-equal."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.manager import (
        CheckpointManager, Placed, shard_train_state, state_leaves,
    )
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import init_train_state

    model = build_model(get_config("qwen3-0.6b").reduced(dtype="bfloat16"))
    tcfg = TrainConfig()
    state = init_train_state(model, tcfg, 0, device="cuda")
    for m in state.opt.mu + state.opt.nu:
        m.normal_()
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, shard_train_state(state, mesh))
    card_target = shard_train_state(init_train_state(model, tcfg, 1, device="cuda"), mesh)
    cpu_target = init_train_state(model, tcfg, 1, device="cpu")
    mgr.restore(card_target)
    mgr.restore(cpu_target)
    for want, on_card, on_cpu in zip(state_leaves(state), state_leaves(card_target),
                                     state_leaves(cpu_target)):
        got = on_card.local if isinstance(on_card, Placed) else on_card
        assert torch.equal(got.reshape(want.shape).cpu(), want.cpu())
        assert torch.equal(on_cpu.cpu(), want.cpu())


# ------------------------------------------------------- the static certifier
@pytest.mark.parametrize("m,k,n", [(1, 1024, 3072), (4, 3072, 1024), (33, 300, 70),
                                   (128, 1024, 3072), (4096, 1024, 1024)])
def test_packed_and_lowrank_launch_plans_are_the_kernels(m, k, n, card):
    """The plans the two tensor-core GEMMs' wrappers launch with equal what
    the built libraries report (``packed_matmul_plan``, ``lowrank_matmul_plan``),
    as lut's and seqmul's do, and the shared-memory model's blocks."""
    from repro_torch.analysis import smem
    from repro_torch.kernels import lowrank_matmul as lr
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels.build import sm_count

    sms = sm_count(card)
    kw = (k + 1) // 2
    plan = pm.launch_plan(m, kw, n, sms)
    want = (((n + plan.bn - 1) // plan.bn, (m + plan.bm - 1) // plan.bm, plan.splits),
            pm.THREADS, pm.smem_bytes(plan.bm))
    assert pm.built_launch_plan(plan, m, kw, n) == want
    assert smem.validate_tiles("inject", 8, 4, (plan.bm, plan.bn)).smem == want[2]
    for rank in (8, 24):
        plan = lr.launch_plan(m, k, n, 8, sms)
        want = (((n + plan.bn - 1) // plan.bn, (m + plan.bm - 1) // plan.bm, plan.splits),
                lr.THREADS, lr.smem_bytes(8, plan.bm, rank))
        assert lr.built_launch_plan(plan, m, k, n, 8, rank) == want
        assert smem.validate_tiles("lowrank", 8, 4, (plan.bm, plan.bn), rank=rank).smem == want[2]


def test_every_built_instantiation_fits_a_hopper_block(card):
    """Registers from ``-Xptxas -v`` times the most threads a wrapper
    launches within 65,536; static plus the most dynamic shared memory
    within 232,448 bytes; at least one block an SM."""
    from repro_torch.analysis import smem

    footprints = smem.built_report(smem.built_logs())
    assert len(footprints) > 100
    for fp in footprints:
        assert fp.registers is not None and fp.within and fp.blocks_per_sm >= 1, fp


def test_armed_gate_refuses_an_uncertified_launch(card, monkeypatch):
    """With ``REPRO_STATIC_AUDIT=1`` an uncertified call raises before any
    launch, and a certified one launches after one check."""
    from repro_torch import engine, kernels
    from repro_torch.analysis import audit

    monkeypatch.setenv("REPRO_STATIC_AUDIT", "1")
    x = torch.randn((4, 64), device=card)
    w = torch.randn((64, 32), device=card)
    kernels.reset_launch_counts()
    audit.GATE_CHECKS.clear()
    with pytest.raises(audit.CertificationError, match="seqmul"):
        engine.matmul(x, w, mode="seqmul", n=13, t=6)
    assert kernels.launch_counts()["seqmul_matmul"] == 0
    engine.matmul(x, w, mode="seqmul", n=12, t=6)
    assert kernels.launch_counts()["seqmul_matmul"] == 1
    assert audit.GATE_CHECKS["seqmul_matmul"] == 1 and audit.GATE_CHECKS["engine.matmul"] == 1


@pytest.mark.parametrize("kernel,n", [("lut_matmul", 8), ("packed_matmul", 8),
                                      ("seqmul_matmul", 12), ("seqmul_matmul", 8)])
@pytest.mark.parametrize("m,k", [(4, 3072), (128, 2048), (33, 40000)])
def test_integer_epilogue_shards_sum_to_the_whole_k(kernel, n, m, k, card):
    """Each K shard's integer epilogue equals its plain version; the shards'
    int64 sums equal the whole K's integer output, whose conversion is the
    float32 output (int64 past ``int32_k_limit`` at K = 40,000)."""
    from repro_torch.engine import artifacts
    from repro_torch.engine.modes import quantize_operands
    from repro_torch.kernels import lut_matmul as lm, packed_matmul as pm, seqmul_matmul as sm

    if kernel == "seqmul_matmul" and k > 4096:
        k = 4096  # int64 at n = 12 already
    x, w = (torch.from_numpy(a).to(card) for a in _operands(m, k, 96, seed=k))
    (mx, sx), (mw, sw), _ = quantize_operands(x, w, n)

    def call(ks, integer, plain=False):
        a, sa, b, sb = (t.contiguous() for t in (mx[:, ks], sx[:, ks], mw[ks], sw[ks]))
        if kernel == "lut_matmul":
            lut = artifacts.product_lut_u16(n, n // 2, True, card)
            fn = lm.lut_matmul_plain if plain else lm.lut_matmul
            return fn(lut, a.to(torch.uint8), sa, b.to(torch.uint8), sb, n=n, integer=integer)
        if kernel == "packed_matmul":
            pa = pm.pack_i16_pairs(a * sa.to(torch.int32), dim=1)
            pb = pm.pack_i16_pairs(b * sb.to(torch.int32), dim=0)
            fn = pm.packed_matmul_plain if plain else pm.packed_matmul
            return fn(pa, pb, n=n, integer=integer)
        fn = sm.seqmul_matmul_plain if plain else sm.seqmul_matmul
        return fn(a.to(torch.int16), sa, b.to(torch.int16), sb, n=n, t=n // 2, integer=integer)

    whole = call(slice(0, k), True)
    assert torch.equal(whole.to(torch.float32), call(slice(0, k), False))
    for shards in (2, 4):
        kl = k // shards
        parts = [call(slice(r * kl, (r + 1) * kl), True) for r in range(shards)]
        for r, part in enumerate(parts):
            want = call(slice(r * kl, (r + 1) * kl), True, plain=True)
            assert part.dtype == want.dtype and torch.equal(part, want)
        assert torch.equal(sum(p.to(torch.int64) for p in parts), whole.to(torch.int64))


@pytest.mark.parametrize("h,kv,hd,t,window", [(16, 8, 128, 48, None), (16, 8, 128, 4096, None),
                                             (10, 1, 256, 4096, 2048), (4, 4, 64, 200, 24)])
def test_flash_decode_lse_ranges_combine_to_the_whole(h, kv, hd, t, window, card):
    """The decode's lse against the plain version's, and (o, lse) over 2 and
    4 slot ranges combined within rtol = atol = 2e-5 of the whole decode;
    a row with no allowed slot included."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(t)
    b = 4
    q = torch.randn((b, h, hd), generator=g, device=card).to(torch.bfloat16)
    k, v = (torch.randn((b, t, kv, hd), generator=g, device=card).to(torch.bfloat16)
            for _ in range(2))
    q_pos = torch.tensor([t - 1, t // 3, 5, 0], device=card, dtype=torch.int32)
    k_pos = torch.arange(t, device=card, dtype=torch.int32)[None].expand(b, t).clone()
    k_pos[3] = -1
    kw = dict(window=window, softcap=None, scale=hd**-0.5)
    o, lse = fa.launch_decode(q, k, v, q_pos, k_pos, with_lse=True, **kw)
    want_o, want_lse = fa.flash_decode_plain(q, k, v, q_pos, k_pos, with_lse=True, **kw)
    torch.testing.assert_close(o, want_o, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
    for shards in (2, 4):
        step = t // shards
        parts = [fa.launch_decode(q, k[:, r * step:(r + 1) * step].contiguous(),
                                  v[:, r * step:(r + 1) * step].contiguous(), q_pos,
                                  k_pos[:, r * step:(r + 1) * step].contiguous(), with_lse=True,
                                  **kw) for r in range(shards)]
        got, _ = fa.combine_ranges(torch.stack([p[0] for p in parts]),
                                   torch.stack([p[1] for p in parts]))
        torch.testing.assert_close(got, o, rtol=2e-5, atol=2e-5)


def test_one_rank_nccl_model_mesh_trains_and_serves_as_unsharded(card, tmp_path):
    """Reduced qwen3-0.6b on the card through the tensor-parallel code on a
    one-rank (1, 1) NCCL mesh: two sharded train steps (bitexact mlp, the
    row-parallel GEMMs on the integer epilogue) give mesh=None's losses,
    and the balanced streams are mesh=None's."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import apply_approx, get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ContinuousScheduler, synth_requests
    from repro_torch.train.steps import init_train_state, make_train_step, shard_batch

    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    torch.distributed.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        cfg = apply_approx(get_config("qwen3-0.6b").reduced(), mode="bitexact", n=8, t=4)
        model, tcfg = build_model(cfg), TrainConfig(total_steps=4, grad_accum=2)
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = {k: torch.randint(0, cfg.vocab_size, (8, 16), generator=gen, device=card)
                 for k in ("tokens", "labels")}
        losses = []
        for m in (None, mesh):
            state = init_train_state(model, tcfg, 0, device="cuda", mesh=m)
            step = make_train_step(model, tcfg, mesh=m)
            kernels.reset_launch_counts()
            got = []
            for _ in range(2):
                state, metrics = step(state, batch if m is None else shard_batch(batch, m, 2))
                got.append(float(metrics["loss"]))
            assert kernels.launch_counts()["lut_matmul"] > 0
            losses.append(got)
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
        base = get_config("qwen3-0.6b").reduced()
        model = build_model(base)
        queue = synth_requests(6, prompt_len=8, gen=4, vocab_size=base.vocab_size, seed=0)
        runs = [ContinuousScheduler(model, model.init_params(0, device="cuda", mesh=m),
                                    batch_size=4, prompt_len=8, max_new=4, quality="balanced",
                                    mesh=m).run(queue) for m in (None, mesh)]
        for r in queue:
            np.testing.assert_array_equal(runs[0].outputs[r.id], runs[1].outputs[r.id])
    finally:
        torch.distributed.destroy_process_group()
