"""The elementwise kernels' plain versions, ``engine.multiply`` and the
legacy shims of the port against the JAX package, bit for bit.

``seqmul_packed_plain`` / ``seqmul_words_plain`` (what the CUDA kernels of
``csrc/seqmul_kernel.cu`` are held to on the card) equal the reference's
Pallas kernels run in interpret mode; ``engine.multiply``,
``kernels.ops`` and ``core.approx_matmul`` equal their reference
counterparts, checks and messages included.  A numpy copy of the kernels'
one-word arithmetic is held to the plain versions too.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro import engine as jax_engine
from repro.core import seqmul as jax_seqmul
from repro.kernels import ops as jax_ops
from repro.kernels.seqmul_kernel import seqmul_pallas, seqmul_pallas_words
from repro_torch import engine
from repro_torch.core import seqmul
from repro_torch.kernels import ops, seqmul_kernel

# both packages' core exports ``approx_matmul``, the function, over the module
jax_approx_matmul = importlib.import_module("repro.core.approx_matmul")
approx_matmul = importlib.import_module("repro_torch.core.approx_matmul")

SHAPES = [(), (1,), (3, 5), (8, 128), (1000,), (64 * 128 + 1,)]


def _operands(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << n, shape, dtype=np.uint64).astype(np.uint32) for _ in range(2))


def _u32(x: torch.Tensor) -> np.ndarray:
    assert x.dtype == torch.uint32
    return x.numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_packed_plain_bitmatches_the_pallas_kernel(shape):
    for n, t, approx, fix in ((8, 4, True, True), (15, 7, True, False), (12, 5, False, False)):
        a, b = _operands(shape, n, seed=n)
        want = seqmul_pallas(jnp.asarray(a), jnp.asarray(b), n=n, t=t, approx=approx,
                             fix_to_1=fix, interpret=True)
        wide = (torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)))
        for ta, tb in ((torch.from_numpy(a), torch.from_numpy(b)), wide):
            got = seqmul_kernel.seqmul_packed_plain(ta, tb, n=n, t=t, approx=approx, fix_to_1=fix)
            assert got.shape == shape
            np.testing.assert_array_equal(_u32(got), np.asarray(want), err_msg=f"n={n} t={t}")
            # the wrapper takes the plain version for CPU tensors
            np.testing.assert_array_equal(
                _u32(seqmul_kernel.seqmul_packed(ta, tb, n=n, t=t, approx=approx, fix_to_1=fix)),
                np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_words_plain_bitmatches_the_pallas_kernel(shape):
    for n, t, approx, fix in ((16, 8, True, True), (16, 15, True, False), (8, 3, False, False)):
        a, b = _operands(shape, n, seed=n + t)
        want = seqmul_pallas_words(jnp.asarray(a), jnp.asarray(b), n=n, t=t, approx=approx,
                                   fix_to_1=fix, interpret=True)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        for got in (seqmul_kernel.seqmul_words_plain(ta, tb, n=n, t=t, approx=approx, fix_to_1=fix),
                    seqmul_kernel.seqmul_words(ta, tb, n=n, t=t, approx=approx, fix_to_1=fix)):
            for g, w in zip(got, want):
                assert g.shape == shape
                np.testing.assert_array_equal(_u32(g), np.asarray(w), err_msg=f"n={n} t={t}")


@pytest.mark.parametrize("t", [1, 8, 15])
def test_words_assemble_to_the_seq_mul_product_at_n16(t):
    """``low + (high << n)`` is the product ``assemble_product_u64`` builds
    from ``seq_mul_words``, at the paper's n = 16."""
    a, b = _operands((1 << 14,), 16, seed=t)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for fix in (True, False):
        low, high = seqmul_kernel.seqmul_words(ta, tb, n=16, t=t, fix_to_1=fix)
        got = low.numpy().astype(np.uint64) + (high.numpy().astype(np.uint64) << np.uint64(16))
        words = seqmul.seq_mul_words(ta, tb, n=16, t=t, approx=True, fix_to_1=fix)
        np.testing.assert_array_equal(got, seqmul.assemble_product_u64(words, n=16, t=t))
        assert int(low.numpy().max()) < 1 << 16


def _one_word_words(a, b, *, n, t, approx, fix_to_1):
    """``words_product`` of ``csrc/seqmul_kernel.cu`` in numpy (uint32)."""
    a, b = a.astype(np.uint32), b.astype(np.uint32)
    bit_t = np.uint32(1 << t)
    w, c_prev, lo = (np.zeros_like(a) for _ in range(3))
    for j in range(n):
        aug = w >> np.uint32(1)
        m = np.where((b >> np.uint32(j)) & np.uint32(1), a, np.uint32(0))
        s = aug + m
        if approx:
            c = (s ^ aug ^ m) & bit_t
            w = s - c + c_prev
            c_prev = c
        else:
            w = s
        lo |= (s & np.uint32(1)) << np.uint32(j)
    lo_mask = np.uint32((1 << (n - 1)) - 1 if n > 1 else 0)
    lo &= lo_mask
    if approx and fix_to_1:
        hit = c_prev != 0
        lo = np.where(hit, lo_mask, lo)
        w = np.where(hit, w | ((bit_t << np.uint32(1)) - np.uint32(1)), w)
    low = lo | ((w & np.uint32(1)) << np.uint32(n - 1))
    return low, w >> np.uint32(1), lo + (w << np.uint32(n - 1))


@pytest.mark.parametrize("n", [1, 2, 4, 8, 15, 16])
def test_kernel_arithmetic_in_uint32_equals_the_plain_versions(n):
    """The kernels' one-word recurrence, in uint32 as on the card, gives the
    plain versions' words: every pair at n <= 8, 2^14 random ones above."""
    if n <= 8:
        v = np.arange(1 << n, dtype=np.uint32)
        a, b = np.repeat(v, 1 << n), np.tile(v, 1 << n)
    else:
        a, b = _operands((1 << 14,), n, seed=n)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for t in sorted({1, max(1, n // 2), max(1, n - 1)}):
        for approx, fix in ((True, True), (True, False), (False, False)):
            low, high, packed = _one_word_words(a, b, n=n, t=t, approx=approx, fix_to_1=fix)
            want_low, want_high = seqmul_kernel.seqmul_words_plain(
                ta, tb, n=n, t=t, approx=approx, fix_to_1=fix)
            np.testing.assert_array_equal(low, want_low.numpy())
            np.testing.assert_array_equal(high, want_high.numpy())
            if 2 * n <= 31:
                want = seqmul_kernel.seqmul_packed_plain(ta, tb, n=n, t=t, approx=approx,
                                                         fix_to_1=fix)
                np.testing.assert_array_equal(packed, want.numpy())


@pytest.mark.parametrize("n,t", [(8, 4), (8, 1), (12, 6), (15, 7), (15, 14), (4, 2)])
def test_multiply_bitmatches_the_reference_backends(n, t):
    """``engine.multiply`` under ``reference`` and ``auto`` (on the CPU: the
    reference body) equals ``repro.engine.multiply`` under ``reference`` and
    ``pallas`` (interpret mode), at the n = 15 packed boundary too."""
    a, b = _operands((16, 130), n, seed=n * t)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for approx in (True, False):
        for fix in (True, False):
            want = np.asarray(jax_engine.multiply(jnp.asarray(a), jnp.asarray(b), n=n, t=t,
                                                  approx=approx, fix_to_1=fix,
                                                  backend="reference"))
            pal = np.asarray(jax_engine.multiply(jnp.asarray(a), jnp.asarray(b), n=n, t=t,
                                                 approx=approx, fix_to_1=fix, backend="pallas"))
            np.testing.assert_array_equal(pal, want)
            for backend in ("reference", "auto"):
                got = engine.multiply(ta, tb, n=n, t=t, approx=approx, fix_to_1=fix,
                                      backend=backend)
                np.testing.assert_array_equal(_u32(got), want, err_msg=backend)


def test_multiply_defaults_resolve_like_the_reference():
    a, b = _operands((5, 7), 8, seed=3)
    want = np.asarray(jax_engine.multiply(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(_u32(engine.multiply(torch.from_numpy(a), torch.from_numpy(b))),
                                  want)
    np.testing.assert_array_equal(_u32(engine.multiply(a, b)), want)


def test_multiply_rejects_packed_2n_32():
    a = torch.ones((4,), dtype=torch.int64)
    with pytest.raises(ValueError) as ei:
        engine.multiply(a, a, n=16, t=8)
    msg = str(ei.value)
    assert "seqmul_approx" in msg and "2n <= 31" in msg
    assert "kernels.seqmul_kernel.seqmul_words" in msg  # the port's two-word entry
    with pytest.raises(ValueError, match="seqmul_exact"):
        engine.multiply(a, a, n=16, t=8, approx=False)


def test_multiply_validation_names_the_mode_like_the_reference():
    a = np.ones(4, np.uint32)
    for kw in (dict(n=8, t=8), dict(n=0, t=1), dict(n=8, t=0, approx=False)):
        with pytest.raises(ValueError) as want:
            jax_engine.multiply(jnp.asarray(a), jnp.asarray(a), **kw)
        with pytest.raises(ValueError) as got:
            engine.multiply(torch.from_numpy(a), torch.from_numpy(a), **kw)
        assert str(got.value) == str(want.value)


def test_multiply_accepts_packed_boundary_n15():
    a = torch.tensor([3], dtype=torch.int64)
    out = engine.multiply(a, a, n=15, t=7, backend="reference")
    assert out.dtype == torch.uint32 and int(out[0]) == 9


def test_multiply_backends_checked_without_fallback():
    one = torch.ones((), dtype=torch.int64)
    with pytest.raises(ValueError) as ei:
        engine.multiply(one, one, backend="pallas")
    for name in engine.BACKENDS:
        assert name in str(ei.value)
    with pytest.raises(ValueError, match="CPU tensor"):
        engine.multiply(one, one, backend="cuda")


def test_operands_follow_the_tensor_operand():
    """An array-like operand joins the tensor operand's device (``meta``
    stands in for the card here), two array-likes go to the CPU, and two
    tensors on different devices raise in every entry point."""
    arr = np.arange(6, dtype=np.uint32)
    away = torch.zeros(6, dtype=torch.uint32, device="meta")
    for x, y in ((arr, away), (away, arr)):
        a, b = seqmul.operands(x, y)
        assert a.device == b.device == away.device and a.dtype == b.dtype == torch.uint32
    a, b = seqmul.operands(arr, arr.tolist())
    assert a.device.type == b.device.type == "cpu" and a.dtype == b.dtype == torch.uint32
    home = torch.from_numpy(arr)
    with pytest.raises(ValueError, match="meta"):
        seqmul.operands(home, away)
    for call in (lambda: engine.multiply(home, away, n=8, t=4, backend="reference"),
                 lambda: ops.approx_multiply(away, home),
                 lambda: seqmul.seq_mul_words(home, away, n=8, t=4, approx=True),
                 lambda: seqmul.seq_mul_approx_u32(away, home, n=8, t=4)):
        with pytest.raises(ValueError, match="meta"):
            call()


def test_kernel_wrappers_check_their_operands():
    a = torch.zeros((4,), dtype=torch.int64)
    with pytest.raises(ValueError) as ei:
        seqmul_kernel.seqmul_words(a, a, n=17, t=8)
    assert "n <= 16" in str(ei.value)
    with pytest.raises(ValueError) as ei:
        seqmul_kernel.seqmul_packed(a, a, n=16, t=8)
    assert "2n <= 31" in str(ei.value) and "seqmul_words" in str(ei.value)
    with pytest.raises(ValueError, match="splitting point"):
        seqmul_kernel.seqmul_packed(a, a, n=8, t=8)
    with pytest.raises(ValueError, match="shape"):
        seqmul_kernel.seqmul_packed(a, a[:3], n=8, t=4)
    with pytest.raises(TypeError, match="integer"):
        seqmul_kernel.seqmul_words(a.float(), a, n=8, t=4)


def test_approx_multiply_shim_bitmatches_the_reference():
    a, b = _operands((8, 128), 8, seed=11)
    for kw in (dict(), dict(n=6, t=2, fix_to_1=False), dict(n=12, t=9)):
        want = np.asarray(jax_ops.approx_multiply(jnp.asarray(a), jnp.asarray(b), **kw))
        got = ops.approx_multiply(torch.from_numpy(a), torch.from_numpy(b), **kw)
        np.testing.assert_array_equal(_u32(got), want)
    with pytest.raises(ValueError, match="2n <= 31"):
        ops.approx_multiply(torch.from_numpy(a), torch.from_numpy(b), n=16, t=8)


@pytest.mark.parametrize("mode", ["bitexact", "lowrank"])
def test_approx_matmul_kernel_shim_matches_the_reference(mode):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    w = rng.standard_normal((64, 24)).astype(np.float32)
    want = np.asarray(jax_ops.approx_matmul_kernel(jnp.asarray(x), jnp.asarray(w), mode=mode))
    got = ops.approx_matmul_kernel(torch.from_numpy(x), torch.from_numpy(w), mode=mode).numpy()
    if mode == "bitexact":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6 * np.abs(want).max())
    with pytest.raises(ValueError, match="kernel modes"):
        ops.approx_matmul_kernel(torch.from_numpy(x), torch.from_numpy(w), mode="seqmul")


@pytest.mark.parametrize("mode", ["exact", "bitexact", "fakequant"])
def test_core_approx_matmul_shim_matches_the_reference(mode):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 48)).astype(np.float32)
    w = rng.standard_normal((48, 12)).astype(np.float32)
    want = np.asarray(jax_approx_matmul.approx_matmul(jnp.asarray(x), jnp.asarray(w), mode=mode,
                                                      n=8, t=3))
    got = approx_matmul.approx_matmul(torch.from_numpy(x), torch.from_numpy(w), mode=mode,
                                      n=8, t=3).numpy()
    if mode == "bitexact":
        np.testing.assert_array_equal(got, want)
    else:  # float32 sums in another order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_core_approx_matmul_int_and_error_moments_match_the_reference():
    rng = np.random.default_rng(7)
    ma = rng.integers(0, 256, (6, 40)).astype(np.uint32)
    mb = rng.integers(0, 256, (40, 9)).astype(np.uint32)
    sa = rng.integers(-1, 2, (6, 40)).astype(np.int8)
    sb = rng.integers(-1, 2, (40, 9)).astype(np.int8)
    want = np.asarray(jax_approx_matmul.approx_matmul_int(
        jnp.asarray(ma), jnp.asarray(sa), jnp.asarray(mb), jnp.asarray(sb), n=8, t=4))
    got = approx_matmul.approx_matmul_int(
        torch.from_numpy(ma.astype(np.int32)), torch.from_numpy(sa),
        torch.from_numpy(mb.astype(np.int32)), torch.from_numpy(sb), n=8, t=4)
    np.testing.assert_array_equal(got.numpy(), want)
    for dist in ("uniform", "gaussian"):
        for fix in (True, False):
            assert approx_matmul.error_moments(8, 4, fix, dist) == \
                jax_approx_matmul.error_moments(8, 4, fix, dist)
    with pytest.raises(ValueError, match="dist"):
        approx_matmul.error_moments(8, 4, True, "laplace")


def test_engine_exports_multiply():
    from repro_torch.engine import dispatch

    assert engine.multiply is dispatch.multiply
    assert dispatch.PACKED_U32_MAX_2N == jax_engine.dispatch.PACKED_U32_MAX_2N == 31
