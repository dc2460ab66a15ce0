"""Product and error lookup tables (counterpart of ``repro/core/luts.py``).

For n <= 8 the full (2^n, 2^n) approximate-product table is small enough
(128 KiB at n=8 as uint16) to sit in one block's shared memory, so the
``bitexact`` GEMM gathers scalar products instead of simulating the
bit-serial datapath (``kernels/lut_matmul.py``).  Tables are built on the
host from the port's own recurrence (``engine/recurrence.py``).  The
rank-r SVD factors of the error table (:func:`svd_error_factors`) back the
``lowrank`` GEMM and attention modes; they are a line-for-line numpy copy
of the reference's, so U and V are bit-equal to ``repro.core.luts``'s.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.engine import recurrence

__all__ = ["product_lut", "error_lut", "svd_error_factors"]


@functools.lru_cache(maxsize=32)
def _tables(n: int, t: int, fix_to_1: bool) -> tuple[np.ndarray, np.ndarray]:
    if n > 10:
        raise ValueError(f"LUT for n={n} would be 2^{2 * n} entries; cap is n<=10")
    v = torch.arange(1 << n, dtype=torch.int64)
    a = v.repeat_interleave(1 << n)
    b = v.repeat(1 << n)
    lo, s_lsp, s_msp, _ = recurrence.seqmul_recurrence(
        a, b, n=n, t=t, approx=True, fix_to_1=fix_to_1
    )
    approx = recurrence.pack_u32(lo, s_lsp, s_msp, n=n, t=t).numpy().reshape(1 << n, 1 << n)
    exact = (a * b).numpy().reshape(1 << n, 1 << n)
    return approx, approx - exact


def product_lut(n: int, t: int, *, fix_to_1: bool = True) -> np.ndarray:
    """(2^n, 2^n) int32 table: LUT[a, b] = approx_product(a, b)."""
    return _tables(n, t, fix_to_1)[0].astype(np.int32)


def error_lut(n: int, t: int, *, fix_to_1: bool = True) -> np.ndarray:
    """(2^n, 2^n) int32 table: E[a, b] = approx(a,b) - a*b."""
    return _tables(n, t, fix_to_1)[1].astype(np.int32)


def svd_error_factors(
    n: int, t: int, rank: int, *, fix_to_1: bool = True
) -> tuple[np.ndarray, np.ndarray, float]:
    """Truncated-SVD factors of the error table.

    Returns (U, V, energy): U (2^n, rank) f32, V (2^n, rank) f32 with
    E ~= U @ V.T (each side carries sqrt of the singular values), and the
    retained squared-Frobenius energy fraction.
    """
    e = _tables(n, t, fix_to_1)[1].astype(np.float64)
    u, s, vt = np.linalg.svd(e, full_matrices=False)
    rank = min(rank, s.size)
    total = float((s**2).sum()) or 1.0
    kept = float((s[:rank] ** 2).sum())
    scale = np.sqrt(s[:rank])
    return (
        (u[:, :rank] * scale).astype(np.float32),
        (vt[:rank].T * scale).astype(np.float32),
        kept / total,
    )
