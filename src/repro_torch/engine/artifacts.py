"""Device-side artifact cache for the approximate-multiply stack.

Counterpart of ``repro/engine/artifacts.py``: product tables, SVD error
factors and error moments are built once per ``(n, t, fix_to_1)`` and, for
tensors, once per device, so a decode step never rebuilds or re-uploads
them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import luts
from repro_torch.device import resolve_device

__all__ = [
    "error_lut", "error_moments", "product_lut", "product_lut_flat", "product_lut_u16",
    "svd_factors",
]


@functools.lru_cache(maxsize=32)
def _int32_table(kind: str, n: int, t: int, fix_to_1: bool, device: torch.device):
    table = (luts.product_lut if kind == "product" else luts.error_lut)(n, t, fix_to_1=fix_to_1)
    return torch.from_numpy(table).to(device)


def product_lut(n: int, t: int, fix_to_1: bool = True, device=None) -> torch.Tensor:
    """(2^n, 2^n) int32 approximate-product table on ``device`` (``cuda``
    unless the caller asks for the CPU)."""
    return _int32_table("product", n, t, fix_to_1, resolve_device(device))


def product_lut_flat(n: int, t: int, fix_to_1: bool = True, device=None) -> torch.Tensor:
    """(2^{2n},) int32 flattened product table (the reference kernel's layout)."""
    return product_lut(n, t, fix_to_1, device).reshape(-1)


def error_lut(n: int, t: int, fix_to_1: bool = True, device=None) -> torch.Tensor:
    """(2^n, 2^n) int32 signed error table (approx - exact) on ``device``."""
    return _int32_table("error", n, t, fix_to_1, resolve_device(device))


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
def svd_factors(n: int, t: int, rank: int, fix_to_1: bool, device: torch.device):
    """Rank-``rank`` SVD factors ``(u, v, energy)`` of the error table:
    ``u``, ``v`` (2^n, rank) float32 on ``device`` (``core.luts``)."""
    u, v, energy = luts.svd_error_factors(n, t, rank, fix_to_1=fix_to_1)
    # v comes out of the SVD transposed (column-major); the kernels take rows
    return (torch.from_numpy(u).to(device).contiguous(),
            torch.from_numpy(v).to(device).contiguous(), energy)


@functools.lru_cache(maxsize=32)
def error_moments(n: int, t: int, fix_to_1: bool = True,
                  dist: str = "gaussian") -> tuple[float, float]:
    """(mean, std) of the signed error table under an operand distribution.

    ``dist="uniform"`` is the paper's Fig. 2 setting; ``dist="gaussian"``
    (the one the ``inject`` body uses) weights the table by the magnitude
    PDF of absmax-quantized Gaussian activations (absmax ~ 4 sigma), as the
    reference does.  The signed per-product error rides ``sign_a *
    sign_b`` and so has zero mean and second moment ``mean^2 + var``,
    which is what is returned.
    """
    e = luts.error_lut(n, t, fix_to_1=fix_to_1).astype(np.float64)
    if dist == "uniform":
        mean, var = float(e.mean()), float(e.var())
    elif dist == "gaussian":
        mags = np.arange(1 << n, dtype=np.float64)
        sigma = (2**n - 1) / 4.0
        p = np.exp(-0.5 * (mags / sigma) ** 2)
        p /= p.sum()
        w = np.outer(p, p)
        mean = float((w * e).sum())
        var = float((w * e * e).sum()) - mean * mean
    else:
        raise ValueError(f"dist must be 'uniform' or 'gaussian', got {dist!r}")
    return 0.0, float(np.sqrt(max(var + mean * mean, 0.0)))
