"""Product and error lookup tables (counterpart of ``repro/core/luts.py``).

For n <= 8 the full (2^n, 2^n) approximate-product table is small enough
(128 KiB at n=8 as uint16) to sit in one block's shared memory, so the
``bitexact`` GEMM gathers scalar products instead of simulating the
bit-serial datapath (``kernels/lut_matmul.py``).  Tables are built on the
host from the port's own recurrence (``engine/recurrence.py``); the SVD
error factors wait for the ``lowrank`` slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.engine import recurrence

__all__ = ["product_lut", "error_lut"]


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
