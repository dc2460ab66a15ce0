"""The port's engine against the JAX package: GEMM bodies, tiers, gradients.

The ``bitexact``, ``seqmul`` and ``inject`` GEMMs of ``repro_torch`` are
held bit-equal to both the JAX reference body and the JAX Pallas body
(interpret mode on the CPU), on the same numpy operands and, for
``inject``, the same noise.  On the CPU each kernel wrapper of the port
runs its plain version, so the port's ``cuda`` bodies (packing, casts,
scales) are checked here too; the kernels themselves are held against
the plain versions on the card by ``chip_smoke.py`` and by the
``gpu``-marked test at the end.

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


@pytest.mark.parametrize("mode", ["bitexact", "seqmul", "inject", "fakequant"])
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
    with pytest.raises(ValueError, match="not ported to PyTorch yet.*ROADMAP"):
        engine.matmul(x, w, mode="lowrank")
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


def test_tier_filter_uses_the_integer_envelope():
    """The port's stand-in for the reference's kernel certification."""
    assert config.within_envelope("bitexact", 8, 4)
    assert not config.within_envelope("bitexact", 9, 4)
    assert config.within_envelope("seqmul", 12, 6)
    assert not config.within_envelope("seqmul", 13, 6)
    assert not config.within_envelope("seqmul_approx", 16, 6)
    with pytest.raises(config.QualityError, match="integer envelope"):
        config.resolve_t(10, config.ErrorBudget(max_nmed=1e-2), mode="bitexact")


def test_apply_quality_deploys_the_tier():
    from repro_torch.configs.registry import get_config

    cfg = config.apply_quality(get_config("qwen3-0.6b").reduced(), "balanced")
    assert cfg.approx.enabled and cfg.approx.mode == "bitexact"
    assert cfg.approx.for_target("attn").t == 2 and cfg.approx.for_target("mlp").t == 4
    assert not config.apply_quality(cfg, "exact").approx.enabled


# ------------------------------------------------------------- on the card
@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["lut_matmul", "seqmul_matmul", "packed_matmul"])
def test_kernel_bitmatches_plain_version_on_the_card(kernel):
    """Runs only on an sm_90 card (``python -m pytest -m gpu tests``)."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper (sm_90) card")
    from repro_torch.engine import artifacts
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import seqmul_matmul as sm

    x, w = (torch.from_numpy(a).cuda() for a in _operands(33, 300, 70, seed=1))
    (mx, sx), (mw, sw), _ = modes.quantize_operands(x, w, 8)
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
    assert [build.block_rows(m) for m in (1, 4, 5, 16, 17, 64, 4096)] == [4, 4, 16, 16, 64, 64, 64]
    # int32 sums hold K * (2^(2n) - 1) below 2^31: K <= 32768 at n=8
    assert not build.wide_accumulator(32768, 2**16 - 1)
    assert build.wide_accumulator(32769, 2**16 - 1)
    assert build.wide_accumulator(3072, (2**12 - 1) ** 2)  # seqmul at n=12


def test_kernel_tiles_hold_the_table_in_shared_memory():
    from repro_torch.kernels import build

    assert config.kernel_tiles("bitexact", 8, 4, 4) == build.block_rows(4) == 4
    assert config.kernel_tiles("seqmul", 12, 6, 128) == 64
    assert config._lut_smem_bytes(8, 64) <= config.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):  # a 512 KiB table at n=9
        config.kernel_tiles("bitexact", 9, 4, 4)
