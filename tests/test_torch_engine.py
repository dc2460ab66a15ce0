"""The port's engine against the JAX package: GEMM bodies, tiers, gradients.

The ``bitexact``, ``seqmul`` and ``inject`` GEMMs of ``repro_torch`` are
held bit-equal to both the JAX reference body and the JAX Pallas body
(interpret mode on the CPU), on the same numpy operands and, for
``inject``, the same noise.  On the CPU each kernel wrapper of the port
runs its plain version, so the port's ``cuda`` bodies (packing, casts,
scales) are checked here too; the kernels themselves are held against
the plain versions on the card by ``chip_smoke.py`` and by the
``gpu``-marked tests of ``tests/test_torch_gpu.py``.

Bit-equality with the JAX package holds while its float32 sums are exact
(|partial sum| < 2^24): the port sums exact integers and converts once,
the reference sums in float32 (see ``kernels/csrc/*.cu``).  Every case
below stays inside that range, and the n=12 case asserts it.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.engine import config as jax_config
from repro.engine import modes as jax_modes
from repro_torch import engine
from repro_torch.engine import config, modes

SHAPES = [(16, 128, 24), (5, 77, 9)]
NT = [(4, 2), (6, 3), (8, 2), (8, 4), (8, 7)]


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k**-0.5).astype(np.float32)
    return x, w


def _jax_bodies(mode, x, w, n, t, *extra):
    spec = jax_modes.get_mode(mode)
    p = jax_modes.GemmParams(n=n, t=t, fix_to_1=True, rank=8)
    args = (jnp.asarray(x), jnp.asarray(w), p, *(jnp.asarray(e) for e in extra))
    return np.asarray(spec.reference(*args)), np.asarray(spec.pallas(*args))


def _port_bodies(mode, x, w, n, t, *extra):
    spec = modes.get_mode(mode)
    p = modes.GemmParams(n=n, t=t, fix_to_1=True, rank=8)
    args = (torch.from_numpy(x), torch.from_numpy(w), p, *(torch.from_numpy(e) for e in extra))
    return spec.reference(*args).numpy(), spec.cuda(*args).numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n,t", NT)
@pytest.mark.parametrize("mode", ["bitexact", "seqmul"])
def test_integer_gemms_bitmatch_reference_and_pallas(mode, n, t, shape):
    x, w = _operands(*shape, seed=n * 10 + t)
    want_ref, want_pallas = _jax_bodies(mode, x, w, n, t)
    np.testing.assert_array_equal(want_ref, want_pallas)  # the reference's own contract
    got_ref, got_cuda_body = _port_bodies(mode, x, w, n, t)
    np.testing.assert_array_equal(got_ref, want_ref)
    np.testing.assert_array_equal(got_cuda_body, want_ref)
    got_engine = engine.matmul(torch.from_numpy(x), torch.from_numpy(w), mode=mode, n=n, t=t)
    np.testing.assert_array_equal(got_engine.numpy(), want_ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n,t", [(4, 2), (8, 4), (8, 6)])
def test_inject_gemm_bitmatches_with_noise_passed_in(n, t, shape):
    x, w = _operands(*shape, seed=n + t)
    noise = np.random.default_rng(99).standard_normal((shape[0], shape[2])).astype(np.float32)
    noise *= np.float32(3.0)
    want_ref, want_pallas = _jax_bodies("inject", x, w, n, t, noise)
    np.testing.assert_array_equal(want_ref, want_pallas)
    got_ref, got_cuda_body = _port_bodies("inject", x, w, n, t, noise)
    np.testing.assert_array_equal(got_ref, want_ref)
    np.testing.assert_array_equal(got_cuda_body, want_ref)


def test_seqmul_at_n12_bitmatches():
    """n=12 needs the recurrence GEMM (no table).  Products reach 2^24, so
    the operands are small but for one outlier each (which sets the scale
    and meets only small values), keeping every float32 partial sum of
    the reference exact; asserted on the quantized operands."""
    n, t = 12, 6
    x, w = _operands(6, 16, 10, seed=12)
    x *= np.float32(0.05)
    w *= np.float32(0.05)
    x[0, 0], w[1, 0] = 4.0, 4.0
    (mx, _), (mw, _), _ = jax_modes.quantize_operands(jnp.asarray(x), jnp.asarray(w), n)
    assert int(np.asarray(mx).max()) == int(np.asarray(mw).max()) == 2**n - 1
    bound = (np.asarray(mx, np.float64) @ np.asarray(mw, np.float64)).max()
    assert bound < 2**23, "operands leave the reference's exact float32 range"
    want_ref, want_pallas = _jax_bodies("seqmul", x, w, n, t)
    np.testing.assert_array_equal(want_ref, want_pallas)
    got_ref, got_cuda_body = _port_bodies("seqmul", x, w, n, t)
    np.testing.assert_array_equal(got_ref, want_ref)
    np.testing.assert_array_equal(got_cuda_body, want_ref)


def test_lut_gather_clamps_out_of_range_magnitudes():
    """Magnitudes past 2^n - 1 read the table's edge, as the TPU kernel's
    clamp does (``lut_matmul.py:42-44``)."""
    from repro.engine import artifacts as jax_artifacts
    from repro.kernels.lut_matmul import lut_matmul_pallas
    from repro_torch.engine import artifacts
    from repro_torch.kernels.lut_matmul import lut_matmul

    n, t = 4, 2
    rng = np.random.default_rng(5)
    ma = rng.integers(0, 40, (7, 20)).astype(np.uint32)
    mb = rng.integers(0, 40, (20, 6)).astype(np.uint32)
    sa = rng.choice([-1, 0, 1], (7, 20)).astype(np.int8)
    sb = rng.choice([-1, 0, 1], (20, 6)).astype(np.int8)
    want = np.asarray(lut_matmul_pallas(
        jax_artifacts.product_lut_flat(n, t, True), jnp.asarray(ma),
        jnp.asarray(sa.astype(np.float32)), jnp.asarray(mb), jnp.asarray(sb.astype(np.float32)),
        n=n,
    ))
    got = lut_matmul(
        artifacts.product_lut_u16(n, t, True, torch.device("cpu")),
        torch.from_numpy(ma.astype(np.uint8)), torch.from_numpy(sa),
        torch.from_numpy(mb.astype(np.uint8)), torch.from_numpy(sb), n=n,
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES + [(3, 256, 40)])
@pytest.mark.parametrize("n,t", [(4, 2), (8, 4), (8, 6)])
def test_lowrank_gemm_matches_reference_and_pallas(n, t, shape):
    """``lowrank``: the JAX reference body and its Pallas body (interpret)
    against the port's reference body and its CUDA body (the kernel's
    plain version on the CPU), at ``rtol=2e-6``, the reference's own rule
    (``tests/test_fused_kernels.py``): the SVD correction is a float32 sum
    in another order.  K <= 256 keeps the exact part exact in float32."""
    x, w = _operands(*shape, seed=n * 10 + t + shape[1])
    want_ref, want_pallas = _jax_bodies("lowrank", x, w, n, t)
    np.testing.assert_allclose(want_pallas, want_ref, rtol=2e-6, atol=2e-6)
    got_ref, got_cuda_body = _port_bodies("lowrank", x, w, n, t)
    for got in (got_ref, got_cuda_body):
        np.testing.assert_allclose(got, want_ref, rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(got, want_pallas, rtol=2e-6, atol=2e-6)
    got_engine = engine.matmul(torch.from_numpy(x), torch.from_numpy(w), mode="lowrank", n=n, t=t)
    np.testing.assert_array_equal(got_engine.numpy(), got_ref)


@pytest.mark.parametrize("mode", ["bitexact", "seqmul", "inject", "fakequant", "lowrank"])
def test_straight_through_gradients_are_exact_matmul_gradients(mode):
    x, w = _operands(9, 32, 7, seed=3)
    g = np.random.default_rng(4).standard_normal((9, 7)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    gen = torch.Generator().manual_seed(0) if modes.get_mode(mode).needs_key else None
    out = engine.matmul(tx, tw, mode=mode, n=8, t=4, generator=gen)
    out.backward(torch.from_numpy(g))
    if mode != "fakequant":  # fakequant is differentiable: the STE through its clip
        np.testing.assert_allclose(tx.grad.numpy(), g @ w.T, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tw.grad.numpy(), x.T @ g, rtol=1e-6, atol=1e-6)
    # and equal to the reference's gradients (float32 sums in another order)
    from repro import engine as jax_engine

    kw = dict(mode=mode, n=8, t=4, backend="reference")
    if mode == "inject":
        kw["key"] = jax.random.PRNGKey(0)
    jgx, jgw = jax.grad(
        lambda a, b: jnp.sum(jax_engine.matmul(a, b, **kw) * jnp.asarray(g)), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-6)


def test_dispatch_checks_eagerly():
    x, w = torch.ones((2, 4)), torch.ones((4, 3))
    with pytest.raises(ValueError, match="supports bit-widths n <= 8"):
        engine.matmul(x, w, mode="bitexact", n=9, t=4)
    with pytest.raises(ValueError, match="supports bit-widths n <= 12"):
        engine.matmul(x, w, mode="seqmul", n=13, t=4)
    with pytest.raises(ValueError, match="registered modes"):
        engine.matmul(x, w, mode="nope")
    with pytest.raises(ValueError, match="supports bit-widths n <= 8"):
        engine.matmul(x, w, mode="lowrank", n=9, t=4)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        engine.matmul(x, w, mode="inject", n=8, t=4)
    with pytest.raises(ValueError, match="valid backends"):
        engine.matmul(x, w, backend="pallas")
    with pytest.raises(ValueError, match="CPU tensor"):
        engine.matmul(x, w, mode="bitexact", n=8, t=4, backend="cuda")
    with pytest.raises(ValueError, match="has no CUDA kernel"):
        engine.matmul(x, w, mode="exact", backend="cuda")


def test_auto_backend_runs_the_reference_on_cpu():
    from repro_torch.engine import dispatch, policy

    assert policy.resolve_backend("auto", torch.device("cpu")) == "reference"
    spec = modes.get_mode("bitexact")
    assert dispatch.resolve_backend("auto", spec, torch.device("cpu")) == "reference"
    assert dispatch.resolve_backend("reference", spec, torch.device("cpu")) == "reference"


# ------------------------------------------------------------------ tiers
def test_tiers_resolve_to_the_pinned_splits():
    """``engine/config.py:383-387`` of the reference pins these at n=8."""
    want = {
        "high": {"mlp": 2, "moe": 2, "attn": 1},
        "balanced": {"mlp": 4, "moe": 4, "attn": 2},
        "draft": {"mlp": 4, "moe": 4},
    }
    for tier, splits in want.items():
        qc = config.resolve_tier(tier, n=8)
        assert {q.target: q.t for q in qc.per_target} == splits, tier
        assert qc.mode == {"draft": "inject"}.get(tier, "bitexact")
    assert config.resolve_tier("exact").per_target == ()
    assert config.default_t(8) == 4


@pytest.mark.parametrize("n", range(2, 13))
def test_resolve_t_without_mode_matches_reference(n):
    for tier in ("high", "balanced", "draft"):
        for target, budget in config.get_tier(tier).budgets:
            jbudget = dict(jax_config.get_tier(tier).budgets)[target]
            try:
                want = jax_config.resolve_t(n, jbudget)
            except jax_config.QualityError:
                with pytest.raises(config.QualityError):
                    config.resolve_t(n, budget)
                continue
            got = config.resolve_t(n, budget)
            assert (got.t, got.delay, got.mae) == (want.t, want.delay, want.mae)
            assert got.nmed_est == want.nmed_est and got.er_bound == want.er_bound


def test_tier_cycle_factor_is_monotone():
    f = [config.tier_cycle_factor(t) for t in ("exact", "high", "balanced", "draft")]
    assert f[0] == 1.0
    assert f[0] > f[1] > f[2] > f[3] > 0


@pytest.mark.parametrize("mode,n,t,want", [
    ("bitexact", 8, 4, True), ("bitexact", 9, 4, False), ("seqmul", 12, 6, True),
    ("seqmul", 13, 6, False), ("seqmul_approx", 16, 6, False),
])
def test_tier_filter_uses_the_integer_envelope(mode, n, t, want):
    """The tier filter is the port's static certifier (``analysis.audit``):
    the uint16 table holds n <= 8, seqmul certifies within the dispatch
    contract n <= 12, the packed single word (the elementwise
    ``seqmul_approx``) needs 2n <= 31."""
    from repro_torch.analysis import audit

    got = (audit.certified_elementwise(n, t) if mode == "seqmul_approx"
           else audit.certified(mode, n, t))
    assert got is want
    if mode == "bitexact" and not want:
        with pytest.raises(config.QualityError, match="certification"):
            config.resolve_t(10, config.ErrorBudget(max_nmed=1e-2), mode="bitexact")


def test_apply_quality_deploys_the_tier():
    from repro_torch.configs.registry import get_config

    cfg = config.apply_quality(get_config("qwen3-0.6b").reduced(), "balanced")
    assert cfg.approx.enabled and cfg.approx.mode == "bitexact"
    assert cfg.approx.for_target("attn").t == 2 and cfg.approx.for_target("mlp").t == 4
    assert not config.apply_quality(cfg, "exact").approx.enabled


# -------------------------------------------------- wrapper checks (host)
def test_wrapper_operand_checks_and_launch_parameters():
    """What the wrappers check before a launch, and how they size it; the
    checks are plain host code, run here on CPU tensors."""
    from repro_torch.kernels import build

    dev = torch.device("cpu")
    ok = torch.zeros((4, 6), dtype=torch.int16)
    build.check_operand(ok, "a", torch.int16, (4, 6), dev)
    with pytest.raises(TypeError, match="dtype"):
        build.check_operand(ok.to(torch.int32), "a", torch.int16, (4, 6), dev)
    with pytest.raises(ValueError, match="shape"):
        build.check_operand(ok, "a", torch.int16, (6, 4), dev)
    with pytest.raises(ValueError, match="contiguous"):
        build.check_operand(ok.T, "a", torch.int16, (6, 4), dev)
    with pytest.raises(ValueError, match="is on"):
        build.check_operand(ok, "a", torch.int16, (4, 6), torch.device("meta"))
    from repro_torch.kernels import lut_matmul, seqmul_matmul

    ms = (1, 4, 5, 16, 17, 64, 4096)
    assert [lut_matmul.tile(m)[0] for m in ms] == [4, 4, 16, 16, 32, 32, 32]
    assert [seqmul_matmul.tile(m)[0] for m in ms] == [2, 4, 8, 16, 16, 16, 16]
    # int32 sums hold K * (2^(2n) - 1) below 2^31: K <= 32768 at n=8
    assert not build.wide_accumulator(32768, 2**16 - 1)
    assert build.wide_accumulator(32769, 2**16 - 1)
    assert build.wide_accumulator(3072, (2**12 - 1) ** 2)  # seqmul at n=12


def test_kernel_tiles_hold_the_table_in_shared_memory():
    from repro_torch.analysis import smem
    from repro_torch.kernels import lut_matmul

    assert config.kernel_tiles("bitexact", 8, 4, 4) == lut_matmul.tile(4)[0] == 4
    assert config.kernel_tiles("seqmul", 12, 6, 128) == 16
    assert smem.gemm_footprint("bitexact", 8, lut_matmul.tile(32)).smem <= smem.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):  # a 512 KiB table at n=9
        config.kernel_tiles("bitexact", 9, 4, 4)
    # lowrank: the two (2^n, r) tables as (hi, lo) float pairs grow with r
    # (rounded up to 8); the cp.async ring, planes and entries do not
    assert config.kernel_tiles("lowrank", 8, 4, 128, rank=8) == 64
    rest = 3 * 10240 + 9216 + 8192
    assert smem.gemm_footprint("lowrank", 8, (64, 64), 8).smem == 16 * 257 * 8 + rest == 81_024
    assert smem.gemm_footprint("lowrank", 8, (64, 64), 24).smem == 16 * 257 * 24 + rest
    assert config.kernel_tiles("lowrank", 8, 4, 128, rank=40) == 64
    assert config.kernel_tiles("lowrank", 8, 4, 4, rank=40) == 16
    with pytest.raises(ValueError, match="rank=41"):
        config.kernel_tiles("lowrank", 8, 4, 128, rank=41)


# ------------------------------------- tensor-core GEMM launch plans (host)
@pytest.mark.parametrize("m,lowrank_tile,packed_tile", [
    (1, (16, 128), (8, 128)), (4, (16, 128), (8, 128)), (8, (16, 128), (8, 128)),
    (9, (16, 128), (32, 64)), (16, (16, 128), (32, 64)), (17, (32, 64), (32, 64)),
    (32, (32, 64), (32, 64)), (33, (64, 64), (64, 64)), (128, (64, 64), (64, 64)),
    (4096, (64, 64), (64, 64)),
])
def test_gemm_tiles_are_the_smallest_token_tile_that_holds_m(m, lowrank_tile, packed_tile):
    from repro_torch.kernels import lowrank_matmul as lr
    from repro_torch.kernels import packed_matmul as pm

    assert lr.tile(m) == lowrank_tile and pm.tile(m) == packed_tile
    assert config.kernel_tiles("lowrank", 8, 4, m) == lowrank_tile[0]
    assert config.kernel_tiles("inject", 8, 4, m) == packed_tile[0]


@pytest.mark.parametrize("tiles,k,max_chunk,want", [
    (24, 1024, None, (8, 128)),      # decode up/gate projection: 192 blocks
    (8, 3072, None, (24, 128)),      # decode down projection
    (96, 1024, None, (2, 512)),      # prefill (128 tokens): 192 blocks, one wave
    (264, 1024, None, (1, 1024)),    # two blocks per SM already
    (4, 100, None, (1, 128)),        # too short to split
    (1, 0, None, (1, 32)),
    (3072, 70000, 33024, (3, 33024)),  # the int32 bound alone splits K
])
def test_split_k_fills_the_card_in_whole_stages(tiles, k, max_chunk, want):
    from repro_torch.kernels import build

    assert build.split_k(tiles, k, step=32, min_chunk=128, sms=132, max_chunk=max_chunk) == want


def test_split_k_slices_cover_k_exactly_once():
    from repro_torch.kernels import build

    for tiles in (1, 7, 24, 96, 300):
        for k in (1, 31, 32, 300, 1024, 3072, 70000):
            splits, chunk = build.split_k(tiles, k, step=32, min_chunk=128, sms=132,
                                          max_chunk=33024)
            assert chunk % 32 == 0 and 32 <= chunk <= 33024
            assert (splits - 1) * chunk < k <= splits * chunk
            # no more slices than the card wants, unless the int32 cap forces them
            assert splits <= max(-(-2 * 132 // tiles), -(-k // 33024))


@pytest.mark.parametrize("n", [1, 4, 8])
def test_lowrank_k_chunk_keeps_the_int32_sum_exact(n):
    from repro_torch.kernels import build
    from repro_torch.kernels import lowrank_matmul as lr

    qmax_sq = ((1 << n) - 1) ** 2
    chunk = lr.max_k_chunk(n)
    assert chunk % lr.K_STEP == 0
    assert not build.wide_accumulator(chunk, qmax_sq)
    assert build.wide_accumulator(chunk + lr.K_STEP, qmax_sq)
    plan = lr.launch_plan(4096, 70000, 3072, n)
    assert plan.k_chunk <= chunk and plan.splits * plan.k_chunk >= 70000


def test_lowrank_and_packed_launch_plans_and_workspaces():
    from repro_torch.kernels import build
    from repro_torch.kernels import lowrank_matmul as lr
    from repro_torch.kernels import packed_matmul as pm

    # decode: 24 tiles of 128 columns, K split 11 ways (264 blocks: two a
    # SM); prefill: no int32 cap reached
    plan = lr.launch_plan(4, 1024, 3072, 8)
    assert plan == lr.Plan(16, 128, 11, 96)
    assert lr.workspace_bytes(plan, 4, 3072) == 11 * 4 * 3072 * 8
    assert lr.launch_plan(128, 1024, 3072, 8) == lr.Plan(64, 64, 2, 512)
    assert lr.launch_plan(32, 1024, 3072, 8, sms=66) == lr.Plan(32, 64, 2, 512)
    no_split = lr.launch_plan(4096, 1024, 3072, 8)
    assert no_split.splits == 1 and lr.workspace_bytes(no_split, 4096, 3072) == 0
    # packed works in words (two lanes each); the workspace is int64 when wide
    plan = pm.launch_plan(4, 512, 3072)
    assert plan == pm.Plan(8, 128, 8, 64)
    assert build.workspace_bytes(plan.splits, 4, 3072, wide=False) == 8 * 4 * 3072 * 4
    assert build.workspace_bytes(plan.splits, 4, 3072, wide=True) == 8 * 4 * 3072 * 8
    assert pm.launch_plan(33, 150, 70) == pm.Plan(64, 64, 2, 96)
    assert pm.launch_plan(1, 0, 70).splits == 1


def test_tile_counters_are_zeroed_once_and_grow():
    from repro_torch.kernels import build

    dev = torch.device("cpu")
    buf = build.tile_counters(dev, 10)
    assert buf.dtype == torch.int32 and buf.numel() >= 1024 and not buf.any()
    assert build.tile_counters(dev, 1000) is buf
    grown = build.tile_counters(dev, 5000)
    assert grown.numel() == 5000 and not grown.any()
    assert build.tile_counters(dev, 10) is grown


# ------------------------------------------------ the engine's public API
def _int_operands(m, k, n_cols, n, seed):
    """Sign-magnitude integer operands: magnitudes in [0, 2^n - 1], signs in
    {-1, 0, 1}."""
    rng = np.random.default_rng(seed)
    ma = rng.integers(0, 1 << n, (m, k)).astype(np.uint32)
    mb = rng.integers(0, 1 << n, (k, n_cols)).astype(np.uint32)
    sa = rng.choice([-1, 0, 1], (m, k)).astype(np.int8)
    sb = rng.choice([-1, 0, 1], (k, n_cols)).astype(np.int8)
    return ma, sa, mb, sb


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,t,k", [(4, 2, 64), (6, 3, 100), (8, 4, 256), (8, 7, 129)])
@pytest.mark.parametrize("fn", ["bitexact_gemm_int", "seqmul_gemm_int"])
def test_integer_gemm_entry_points_bitmatch_reference(fn, n, t, k, seed):
    """``engine.bitexact_gemm_int`` / ``seqmul_gemm_int`` against the
    reference's, bit-equal: at n <= 8 and K <= 256 every partial of the
    reference's float32 sum stays below 2^24, where it is exact."""
    ma, sa, mb, sb = _int_operands(5, k, 7, n, seed=seed * 100 + n * 10 + t)
    assert k * ((1 << 2 * n) - 1) < 2**24  # the largest table product is below 2^(2n)
    want = np.asarray(getattr(jax_modes, fn)(
        jnp.asarray(ma), jnp.asarray(sa), jnp.asarray(mb), jnp.asarray(sb), n=n, t=t))
    got = getattr(engine, fn)(torch.from_numpy(ma.astype(np.int64)), torch.from_numpy(sa),
                              torch.from_numpy(mb.astype(np.int64)), torch.from_numpy(sb), n=n, t=t)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,t", [(4, 2), (8, 4)])
def test_seqmul_gemm_int_exact_products_match_reference(n, t):
    """``approx=False`` runs the exact recurrence: the plain integer GEMM."""
    ma, sa, mb, sb = _int_operands(4, 32, 6, n, seed=n + t)
    want = np.asarray(jax_modes.seqmul_gemm_int(
        jnp.asarray(ma), jnp.asarray(sa), jnp.asarray(mb), jnp.asarray(sb), n=n, t=t,
        approx=False))
    got = engine.seqmul_gemm_int(torch.from_numpy(ma.astype(np.int64)), torch.from_numpy(sa),
                                 torch.from_numpy(mb.astype(np.int64)), torch.from_numpy(sb),
                                 n=n, t=t, approx=False)
    np.testing.assert_array_equal(got.numpy(), want)
    exact = (ma.astype(np.int64) * sa) @ (mb.astype(np.int64) * sb)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))


@pytest.mark.parametrize("name", ["product_lut", "product_lut_flat", "error_lut"])
@pytest.mark.parametrize("n,t,fix_to_1", [(4, 2, True), (8, 4, True), (8, 4, False)])
def test_artifact_tables_equal_reference(name, n, t, fix_to_1):
    from repro.engine import artifacts as jax_artifacts
    from repro_torch.engine import artifacts

    want = np.asarray(getattr(jax_artifacts, name)(n, t, fix_to_1))
    got = getattr(artifacts, name)(n, t, fix_to_1, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_operands_is_exported_and_matches_reference():
    x, w = _operands(6, 40, 9, seed=4)
    (jmx, jsx), (jmw, jsw), jscale = jax_modes.quantize_operands(jnp.asarray(x), jnp.asarray(w), 8)
    (mx, sx), (mw, sw), scale = engine.quantize_operands(torch.from_numpy(x),
                                                         torch.from_numpy(w), 8)
    for got, want in ((mx, jmx), (sx, jsx), (mw, jmw), (sw, jsw)):
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(np.float32(scale), np.asarray(jscale, np.float32))
    for name in ("quantize_operands", "bitexact_gemm_int", "seqmul_gemm_int"):
        assert name in engine.__all__
