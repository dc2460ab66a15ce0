"""The port's core numerics against the JAX package, bit for bit.

The recurrence, the product and error tables, absmax calibration,
quantization, int16-pair packing and the closed-form error model of
``repro_torch`` are held to exact equality with ``repro`` on the same
numpy inputs (the recurrence also to the literal boolean transcription
of the paper's equations in ``repro.core.boolean_ref``).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import boolean_ref
from repro.core import error_model as jax_error_model
from repro.core import luts as jax_luts
from repro.core import quantization as jax_quant
from repro.engine import recurrence as jax_recurrence
from repro.kernels.packed_matmul import pack_i16_pairs as jax_pack_i16_pairs
from repro_torch.core import error_model, luts, quantization
from repro_torch.engine import recurrence
from repro_torch.kernels.packed_matmul import pack_i16_pairs


def _all_pairs(n: int) -> tuple[np.ndarray, np.ndarray]:
    v = np.arange(1 << n, dtype=np.uint32)
    return np.repeat(v, 1 << n), np.tile(v, 1 << n)


def _splits(n: int) -> range:
    return range(1, max(1, n - 1) + 1)


@pytest.mark.parametrize("n", range(1, 9))
def test_recurrence_bitmatches_reference_exhaustively(n):
    """Every (a, b) at this n, every t, both fix_to_1, approx and exact:
    all four words equal the JAX recurrence's, and the assembled product
    equals the boolean transcription of the paper's equations."""
    a, b = _all_pairs(n)
    ta, tb = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    a_bits, b_bits = boolean_ref.bits_from_int(a, n), boolean_ref.bits_from_int(b, n)
    exact_bits = boolean_ref.int_from_bits(boolean_ref.mul_exact_bits(a_bits, b_bits))
    for t in _splits(n):
        for approx in (True, False):
            for fix in ((True, False) if approx else (False,)):
                want = jax_recurrence.seqmul_recurrence(
                    jnp.asarray(a), jnp.asarray(b), n=n, t=t, approx=approx, fix_to_1=fix
                )
                got = recurrence.seqmul_recurrence(ta, tb, n=n, t=t, approx=approx, fix_to_1=fix)
                for name, w, g in zip(("lo", "s_lsp", "s_msp", "c_last"), want, got):
                    np.testing.assert_array_equal(
                        np.asarray(w, np.int64), g.numpy(),
                        err_msg=f"{name} differs at n={n} t={t} approx={approx} fix={fix}",
                    )
                prod = recurrence.pack_u32(*got[:3], n=n, t=t).numpy().astype(np.uint64)
                if approx:
                    bits = boolean_ref.mul_approx_bits(a_bits, b_bits, t=t, fix_to_1=fix)
                    oracle = boolean_ref.int_from_bits(bits)
                else:
                    oracle = exact_bits
                np.testing.assert_array_equal(prod, oracle)


def _one_word_product(a, b, *, n, t, approx, fix_to_1):
    """The one-word recurrence of ``csrc/seqmul_kernel.cu`` in numpy: both
    words of the accumulator in one (s_lsp in bits [0, t), s_msp above)."""
    bit_t = 1 << t
    w, c_prev, lo = (np.zeros_like(a) for _ in range(3))
    for j in range(n):
        aug = w >> 1
        m = np.where((b >> j) & 1, a, 0)
        s = aug + m
        c = (s ^ aug ^ m) & bit_t
        w = s - c + c_prev if approx else s
        c_prev = c
        lo |= (s & 1) << j
    lo_mask = (1 << (n - 1)) - 1 if n > 1 else 0
    lo &= lo_mask
    if approx and fix_to_1:
        hit = c_prev != 0
        lo = np.where(hit, lo_mask, lo)
        w = np.where(hit, w | ((bit_t << 1) - 1), w)
    return lo + (w << (n - 1))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 12])
def test_one_word_form_of_the_seqmul_kernel_equals_the_recurrence(n):
    """The elementwise CUDA kernel's form of the recurrence gives the
    product of the port's recurrence (held to the JAX one above), the plain
    version the kernel is checked against on the card: every (a, b) at
    n <= 8, 2^16 random pairs at n = 12."""
    if n <= 8:
        a, b = _all_pairs(n)
    else:
        rng = np.random.default_rng(n)
        a, b = rng.integers(0, 1 << n, (2, 1 << 16), dtype=np.uint32)
    a64, b64 = a.astype(np.int64), b.astype(np.int64)
    ta, tb = torch.from_numpy(a64), torch.from_numpy(b64)
    for t in _splits(n):
        for approx in (True, False):
            for fix in ((True, False) if approx else (False,)):
                words = recurrence.seqmul_recurrence(ta, tb, n=n, t=t, approx=approx,
                                                     fix_to_1=fix)
                want = recurrence.pack_u32(*words[:3], n=n, t=t).numpy()
                got = _one_word_product(a64, b64, n=n, t=t, approx=approx, fix_to_1=fix)
                np.testing.assert_array_equal(
                    got, want, err_msg=f"n={n} t={t} approx={approx} fix={fix}")


@pytest.mark.parametrize("n,t", [(0, 1), (9, 0), (4, 4), (33, 2), (1, 2)])
def test_validate_nt_rejects_what_the_reference_rejects(n, t):
    with pytest.raises(ValueError):
        jax_recurrence.validate_nt(n, t)
    with pytest.raises(ValueError):
        recurrence.validate_nt(n, t)


@pytest.mark.parametrize("fix_to_1", [True, False])
@pytest.mark.parametrize("n,t", [(2, 1), (4, 2), (6, 3), (8, 1), (8, 4), (8, 7)])
def test_product_and_error_luts_bitmatch(n, t, fix_to_1):
    np.testing.assert_array_equal(
        luts.product_lut(n, t, fix_to_1=fix_to_1), jax_luts.product_lut(n, t, fix_to_1=fix_to_1)
    )
    np.testing.assert_array_equal(
        luts.error_lut(n, t, fix_to_1=fix_to_1), jax_luts.error_lut(n, t, fix_to_1=fix_to_1)
    )


@pytest.mark.parametrize("n,t,rank", [(4, 2, 4), (6, 3, 8), (8, 2, 8), (8, 4, 8), (8, 4, 4),
                                      (8, 7, 16)])
def test_svd_error_factors_bitmatch(n, t, rank):
    """The ``lowrank`` mode's SVD factors: the same float64 SVD, split and
    cast, so U and V are bit-equal and the energy equal."""
    u, v, energy = luts.svd_error_factors(n, t, rank)
    ju, jv, jenergy = jax_luts.svd_error_factors(n, t, rank)
    assert u.dtype == v.dtype == np.float32 and u.shape == (1 << n, rank)
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(v, jv)
    assert energy == jenergy


def test_quantize_divides_a_bf16_input_in_float32():
    """jnp promotes a bf16 tensor against the float32 scale and divides in
    float32; torch keeps bf16 for a 0-d scale unless told (a value at 95.43
    quanta rounds to 95.5 in bf16 and then to 96)."""
    x = np.random.default_rng(2).standard_normal((3, 5, 4, 16)).astype(np.float32) * 1.7
    xb = jnp.asarray(x, jnp.bfloat16)
    tb = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    qp_j = jax_quant.calibrate_absmax(xb, bits=8)
    qp_t = quantization.calibrate_absmax(tb, bits=8)
    np.testing.assert_array_equal(np.asarray(qp_j.scale), qp_t.scale.numpy())
    mag_j, sign_j = jax_quant.quantize(xb, qp_j)
    mag_t, sign_t = quantization.quantize(tb, qp_t)
    np.testing.assert_array_equal(np.asarray(mag_j, np.int64), mag_t.numpy())
    np.testing.assert_array_equal(np.asarray(sign_j), sign_t.numpy())


@pytest.mark.parametrize("bits", [2, 4, 8, 12, 15])
def test_quantize_and_calibrate_bitmatch(bits):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((37, 53)) * rng.uniform(0.01, 30.0)).astype(np.float32)
    # exact ties at +-0.5 quanta, where round-half-to-even decides
    x[0, :8] = np.float32(0.5) * np.arange(-4, 4, dtype=np.float32)
    qp_j = jax_quant.calibrate_absmax(jnp.asarray(x), bits=bits)
    qp_t = quantization.calibrate_absmax(torch.from_numpy(x), bits=bits)
    np.testing.assert_array_equal(np.asarray(qp_j.scale), qp_t.scale.numpy())
    mag_j, sign_j = jax_quant.quantize(jnp.asarray(x), qp_j)
    mag_t, sign_t = quantization.quantize(torch.from_numpy(x), qp_t)
    np.testing.assert_array_equal(np.asarray(mag_j, np.int64), mag_t.numpy())
    np.testing.assert_array_equal(np.asarray(sign_j), sign_t.numpy())
    # per-row calibration and the straight-through fake quantizer
    qp_j = jax_quant.calibrate_absmax(jnp.asarray(x), bits=bits, axis=1)
    qp_t = quantization.calibrate_absmax(torch.from_numpy(x), bits=bits, dim=1)
    np.testing.assert_array_equal(np.asarray(qp_j.scale), qp_t.scale.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax_quant.fake_quant(jnp.asarray(x), bits=bits)),
        quantization.fake_quant(torch.from_numpy(x), bits=bits).numpy(),
    )


def test_fake_quant_gradient_matches_reference():
    """Straight through the rounding; the clip splits the gradient of the
    absmax elements (a tie with the bound) in both packages."""
    import jax

    x = np.linspace(-2.0, 2.0, 11, dtype=np.float32)
    want = jax.grad(lambda v: jax_quant.fake_quant(v, bits=4).sum())(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    quantization.fake_quant(tx, bits=4).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))
    assert tx.grad[5] == 1.0 and tx.grad[0] == 0.5


@pytest.mark.parametrize("shape,dim", [((6, 10), 1), ((7, 5), 0), ((3, 9), 1), ((11, 4), 0)])
def test_pack_i16_pairs_bitmatches(shape, dim):
    rng = np.random.default_rng(sum(shape))
    q = rng.integers(-(2**15) + 1, 2**15, size=shape, dtype=np.int32)
    q.flat[0], q.flat[-1] = -(2**15) + 1, 2**15 - 1
    want = np.asarray(jax_pack_i16_pairs(jnp.asarray(q), axis=dim))
    got = pack_i16_pairs(torch.from_numpy(q), dim=dim).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("n,t", [(4, 2), (8, 3), (8, 4), (12, 6), (16, 5)])
def test_error_model_copy_matches(n, t, order):
    assert error_model.mae_closed_form(n, t) == jax_error_model.mae_closed_form(n, t)
    # two report classes with the same fields: compare field by field (the
    # reprs print every float exactly)
    assert repr(error_model.estimate(n, t, order=order)) == repr(
        jax_error_model.estimate(n, t, order=order)
    )


@pytest.mark.parametrize("n,t", [(4, 2), (8, 4), (8, 6)])
def test_inject_error_moments_match(n, t):
    from repro.engine import artifacts as jax_artifacts
    from repro_torch.engine import artifacts

    assert artifacts.error_moments(n, t) == jax_artifacts.error_moments(n, t)
