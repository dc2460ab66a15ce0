"""Device-side artifact cache for the approximate-multiply stack.

Counterpart of ``repro/engine/artifacts.py``: product tables and error
moments are built once per ``(n, t, fix_to_1)`` and, for tables, once per
device, so a decode step never rebuilds or re-uploads them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import luts

__all__ = ["product_lut_u16", "error_moments"]


@functools.lru_cache(maxsize=32)
def product_lut_u16(n: int, t: int, fix_to_1: bool, device: torch.device) -> torch.Tensor:
    """(2^{2n},) uint16 flattened product table on ``device``: the layout the
    CUDA ``lut_matmul`` kernel copies into shared memory.  Products stay
    below 2^16 for n <= 8 (128 KiB at n=8, where int32 would be 256 KiB,
    over the 227 KiB a block may use); checked here, not assumed."""
    table = luts.product_lut(n, t, fix_to_1=fix_to_1)
    if int(table.max()) >= 1 << 16:
        raise ValueError(f"product table for n={n}, t={t} does not fit uint16")
    return torch.from_numpy(table.astype(np.uint16).reshape(-1)).to(device)


@functools.lru_cache(maxsize=32)
def error_moments(n: int, t: int, fix_to_1: bool = True) -> tuple[float, float]:
    """(mean, std) of the signed error table, weighted by the magnitude
    PDF of absmax-quantized Gaussian activations (absmax ~ 4 sigma), as the
    reference's ``dist="gaussian"`` (the one its ``inject`` body uses).
    The signed per-product error rides ``sign_a * sign_b`` and so has zero
    mean and second moment ``mean^2 + var``, which is what is returned.
    """
    e = luts.error_lut(n, t, fix_to_1=fix_to_1).astype(np.float64)
    mags = np.arange(1 << n, dtype=np.float64)
    sigma = (2**n - 1) / 4.0
    p = np.exp(-0.5 * (mags / sigma) ** 2)
    p /= p.sum()
    w = np.outer(p, p)
    mean = float((w * e).sum())
    var = float((w * e * e).sum()) - mean * mean
    return 0.0, float(np.sqrt(max(var + mean * mean, 0.0)))
