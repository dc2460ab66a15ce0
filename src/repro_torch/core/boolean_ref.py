"""Literal boolean reference of the paper's multiplier recurrences.

A line-for-line numpy copy of ``repro/core/boolean_ref.py``, so that the
port holds its recurrence against the paper's equations without importing
the JAX package.  It transcribes the Ŝ_i^j / Ĉ_i^j equations of Section
IV-A (and the exact S_i^j / C_i^j of Section III-A) *verbatim*, bit by
bit, with numpy — no word-level shortcuts.  It is deliberately slow and
serves as the ground-truth oracle for ``core.seqmul`` and the CUDA kernels.

Bits are LSB-first: ``bits[..., i]`` is bit i.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "bits_from_int",
    "int_from_bits",
    "mul_exact_bits",
    "mul_approx_bits",
]


def bits_from_int(x, n: int) -> np.ndarray:
    x = np.asarray(x, np.uint64)
    i = np.arange(n, dtype=np.uint64)
    return ((x[..., None] >> i) & np.uint64(1)).astype(np.uint8)


def int_from_bits(bits: np.ndarray) -> np.ndarray:
    n = bits.shape[-1]
    w = np.uint64(1) << np.arange(n, dtype=np.uint64)
    return (bits.astype(np.uint64) * w).sum(axis=-1, dtype=np.uint64)


def _mul_bits(a_bits: np.ndarray, b_bits: np.ndarray, t: int | None, fix_to_1: bool):
    """Shared driver.  ``t=None`` selects the exact recurrence (III-A)."""
    n = a_bits.shape[-1]
    a = a_bits.astype(np.uint8)
    b = b_bits.astype(np.uint8)
    batch = a.shape[:-1]
    p = np.zeros(batch + (2 * n,), np.uint8)

    # S has n+1 bits (S_n is the registered adder carry-out).
    S = np.zeros(batch + (n + 1,), np.uint8)
    # j = 0: S_i^0 = a_i & b_0, no carries.
    for i in range(n):
        S[..., i] = a[..., i] & b[..., 0]
    c_prev_ff = np.zeros(batch, np.uint8)  # Ĉ_{t-1}^{j-1} held in the D-FF
    p[..., 0] = S[..., 0]  # p_r = S_0^r for r in [0, n-1)

    for j in range(1, n):
        S_new = np.zeros_like(S)
        C = np.zeros(batch + (n,), np.uint8)  # C_i^j, i in [0, n)
        c_ff_out = np.zeros(batch, np.uint8)
        for i in range(n):
            m = a[..., i] & b[..., j]
            aug = S[..., i + 1]  # S_{i+1}^{j-1}
            if i == 0:
                S_new[..., 0] = aug ^ m
                C[..., 0] = aug & m
            elif t is not None and i == t:
                # segmented: carry-in is last cycle's LSP carry-out (D-FF)
                S_new[..., i] = aug ^ m ^ c_prev_ff
                C[..., i] = ((aug ^ m) & c_prev_ff) | (aug & m)
            else:
                c_in = C[..., i - 1]
                S_new[..., i] = aug ^ c_in ^ m
                C[..., i] = ((aug ^ m) & c_in) | (aug & m)
            if t is not None and i == t - 1:
                # Ĉ_{t-1}^{j} -> D-FF.  It does NOT ripple into bit t within
                # this cycle (the i == t branch above consumes c_prev_ff).
                c_ff_out = C[..., t - 1]
        S_new[..., n] = C[..., n - 1]  # S_n^j = C_{n-1}^j
        S = S_new
        c_prev_ff = c_ff_out
        if j < n - 1:
            p[..., j] = S[..., 0]

    # p_r = S_{r-n+1}^{n-1} for r in [n-1, 2n-1]
    for r in range(n - 1, 2 * n):
        p[..., r] = S[..., r - n + 1]

    if t is not None and fix_to_1:
        hit = c_prev_ff.astype(bool)  # Ĉ_{t-1}^{n-1}
        p[..., : n + t] = np.where(hit[..., None], np.uint8(1), p[..., : n + t])
    return p


def mul_exact_bits(a_bits: np.ndarray, b_bits: np.ndarray) -> np.ndarray:
    """Exact sequential multiplication per Section III-A."""
    return _mul_bits(a_bits, b_bits, t=None, fix_to_1=False)


def mul_approx_bits(
    a_bits: np.ndarray, b_bits: np.ndarray, *, t: int, fix_to_1: bool = True
) -> np.ndarray:
    """Approximate multiplication per Section IV-A (segmented carry chain).

    Accepts the same degenerate n=1 split as ``engine.recurrence
    .validate_nt`` (t=1: single-cycle product, no carry to defer, exact
    and approximate coincide).
    """
    n = a_bits.shape[-1]
    if not (1 <= t <= max(1, n - 1)):
        raise ValueError(f"t={t} out of range for n={n}")
    return _mul_bits(a_bits, b_bits, t=t, fix_to_1=fix_to_1)
