"""The port's elementwise multiplier (``repro_torch.core.seqmul``) and its
boolean oracle against the JAX package, bit for bit.

``seq_mul_words``, ``seq_mul_exact_u32`` and ``seq_mul_approx_u32`` of
``repro_torch`` are held to exact equality with ``repro.core.seqmul`` on
the same numpy inputs (every pair at n <= 8, random pairs at n = 12, 16,
24 and 32), the port's copy of ``core.boolean_ref`` to the reference's,
and the port's recurrence to its own boolean oracle.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import boolean_ref as jax_boolean_ref
from repro.core import seqmul as jax_seqmul
from repro_torch.core import boolean_ref, seqmul


def _all_pairs(n: int) -> tuple[np.ndarray, np.ndarray]:
    v = np.arange(1 << n, dtype=np.uint32)
    return np.repeat(v, 1 << n), np.tile(v, 1 << n)


def _random_pairs(n: int, size: int = 1 << 12) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(n)
    return (rng.integers(0, 1 << n, size, dtype=np.uint64).astype(np.uint32) for _ in range(2))


def _splits(n: int) -> range:
    return range(1, max(1, n - 1) + 1)


def _check_words(a, b, *, n, t, approx, fix_to_1):
    want = jax_seqmul.seq_mul_words(a, b, n=n, t=t, approx=approx, fix_to_1=fix_to_1)
    got = seqmul.seq_mul_words(torch.from_numpy(a), torch.from_numpy(b), n=n, t=t,
                               approx=approx, fix_to_1=fix_to_1)
    for name, w, g in zip(seqmul.ProductWords._fields, want, got):
        assert g.dtype == torch.uint32
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(w),
            err_msg=f"{name} at n={n} t={t} approx={approx} fix={fix_to_1}")
    np.testing.assert_array_equal(seqmul.assemble_product_u64(got, n=n, t=t),
                                  jax_seqmul.assemble_product_u64(want, n=n, t=t))


def _check_packed(a, b, *, n, t):
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = seqmul.seq_mul_exact_u32(ta, tb, n=n)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_seqmul.seq_mul_exact_u32(a, b, n=n)))
    for fix in (True, False):
        got = seqmul.seq_mul_approx_u32(ta, tb, n=n, t=t, fix_to_1=fix)
        want = jax_seqmul.seq_mul_approx_u32(a, b, n=n, t=t, fix_to_1=fix)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"n={n} t={t} fix={fix}")


@pytest.mark.parametrize("n", range(1, 9))
def test_seq_mul_bitmatches_reference_exhaustively(n):
    """Every (a, b) at this n, every t, fix_to_1 both ways (and the exact
    multiplier): the four words, the assembled product and both packed
    forms equal the JAX package's."""
    a, b = _all_pairs(n)
    for t in _splits(n):
        for fix in (True, False):
            _check_words(a, b, n=n, t=t, approx=True, fix_to_1=fix)
        _check_packed(a, b, n=n, t=t)
    _check_words(a, b, n=n, t=max(1, n // 2), approx=False, fix_to_1=False)


@pytest.mark.parametrize("n", [12, 16, 24, 32])
def test_seq_mul_bitmatches_reference_on_random_pairs(n):
    """2^12 random pairs at the wide bit-widths (the paper's Monte-Carlo
    range reaches n = 32), at three splits, fix_to_1 both ways."""
    a, b = _random_pairs(n)
    for t in (1, n // 2, n - 1):
        for fix in (True, False):
            _check_words(a, b, n=n, t=t, approx=True, fix_to_1=fix)
        if 2 * n <= 31:
            _check_packed(a, b, n=n, t=t)
    _check_words(a, b, n=n, t=n // 2, approx=False, fix_to_1=False)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_boolean_ref_copy_equals_the_reference(n):
    a, b = _all_pairs(n)
    bits_a, bits_b = boolean_ref.bits_from_int(a, n), boolean_ref.bits_from_int(b, n)
    np.testing.assert_array_equal(bits_a, jax_boolean_ref.bits_from_int(a, n))
    np.testing.assert_array_equal(boolean_ref.int_from_bits(bits_a),
                                  jax_boolean_ref.int_from_bits(bits_a))
    np.testing.assert_array_equal(boolean_ref.mul_exact_bits(bits_a, bits_b),
                                  jax_boolean_ref.mul_exact_bits(bits_a, bits_b))
    for t in _splits(n):
        for fix in (True, False):
            np.testing.assert_array_equal(
                boolean_ref.mul_approx_bits(bits_a, bits_b, t=t, fix_to_1=fix),
                jax_boolean_ref.mul_approx_bits(bits_a, bits_b, t=t, fix_to_1=fix))
    with pytest.raises(ValueError):
        boolean_ref.mul_approx_bits(bits_a, bits_b, t=n + 1)


@pytest.mark.parametrize("n", range(1, 7))
def test_seq_mul_words_equals_the_ports_boolean_oracle(n):
    """The port's recurrence against its own copy of the paper's Ŝ/Ĉ
    equations, without the JAX package in between."""
    a, b = _all_pairs(n)
    bits_a, bits_b = boolean_ref.bits_from_int(a, n), boolean_ref.bits_from_int(b, n)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    exact = seqmul.seq_mul_words(ta, tb, n=n, t=max(1, n // 2), approx=False)
    np.testing.assert_array_equal(
        seqmul.assemble_product_u64(exact, n=n, t=max(1, n // 2)),
        boolean_ref.int_from_bits(boolean_ref.mul_exact_bits(bits_a, bits_b)))
    for t in _splits(n):
        for fix in (True, False):
            w = seqmul.seq_mul_words(ta, tb, n=n, t=t, approx=True, fix_to_1=fix)
            oracle = boolean_ref.mul_approx_bits(bits_a, bits_b, t=t, fix_to_1=fix)
            np.testing.assert_array_equal(seqmul.assemble_product_u64(w, n=n, t=t),
                                          boolean_ref.int_from_bits(oracle))


def test_seq_mul_takes_numpy_scalars_and_keeps_the_shape():
    """As the reference's quickstart calls it: numpy uint32 scalars in, 0-d
    uint32 words out; an empty input gives empty words."""
    w = seqmul.seq_mul_words(np.uint32(183), np.uint32(201), n=8, t=4, approx=True)
    assert all(x.shape == () and x.dtype == torch.uint32 for x in w)
    want = jax_seqmul.seq_mul_words(np.uint32(183), np.uint32(201), n=8, t=4, approx=True)
    assert int(seqmul.assemble_product_u64(w, n=8, t=4)) == int(
        jax_seqmul.assemble_product_u64(want, n=8, t=4))
    empty = seqmul.seq_mul_words(np.zeros((0, 3), np.uint32), np.zeros((0, 3), np.uint32),
                                 n=8, t=4, approx=True)
    assert all(x.shape == (0, 3) for x in empty)


def test_n1_degenerate_split():
    """n=1 with t=1 is accepted (no MSP to segment): exact == approx == a*b."""
    from repro_torch.engine.recurrence import validate_nt

    validate_nt(1, 1)
    with pytest.raises(ValueError, match="degenerate"):
        validate_nt(1, 2)
    a, b = _all_pairs(1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(seqmul.seq_mul_exact_u32(ta, tb, n=1).numpy(), a * b)
    for fix in (False, True):
        np.testing.assert_array_equal(
            seqmul.seq_mul_approx_u32(ta, tb, n=1, t=1, fix_to_1=fix).numpy(), a * b)
    w = seqmul.seq_mul_words(ta, tb, n=1, t=1, approx=True)
    np.testing.assert_array_equal(seqmul.assemble_product_u64(w, n=1, t=1), a * b)
    np.testing.assert_array_equal(w.c_last.numpy(), np.zeros_like(a))


@pytest.mark.parametrize("n,t", [(0, 1), (8, 8), (33, 4), (8, 0)])
def test_validation_errors_match_the_reference(n, t):
    a = np.zeros(4, np.uint32)
    with pytest.raises(ValueError) as want:
        jax_seqmul.seq_mul_words(a, a, n=n, t=t, approx=True)
    with pytest.raises(ValueError) as got:
        seqmul.seq_mul_words(a, a, n=n, t=t, approx=True)
    assert str(got.value) == str(want.value)


def test_packed_forms_reject_2n_over_31_as_the_reference_does():
    a = np.zeros(4, np.uint32)
    with pytest.raises(ValueError) as want:
        jax_seqmul.seq_mul_approx_u32(a, a, n=16, t=8)
    with pytest.raises(ValueError) as got:
        seqmul.seq_mul_approx_u32(a, a, n=16, t=8)
    assert str(got.value) == str(want.value)
    assert "seq_mul_words" in str(got.value)
    with pytest.raises(ValueError, match="2n <= 31"):
        seqmul.seq_mul_exact_u32(a, a, n=16)
    assert seqmul.MAX_N == jax_seqmul.MAX_N == 32
