"""Compatibility shim over ``repro_torch.engine`` (the old reference GEMM API).

Counterpart of ``repro/core/approx_matmul.py``.  ``approx_matmul`` pins
``backend="reference"``, the plain PyTorch mode bodies, on any device; new
code calls ``repro_torch.engine.matmul``, which also picks the CUDA
kernels for CUDA tensors.
"""

from __future__ import annotations

from typing import Literal, Optional

import torch

from repro_torch.engine import artifacts as _artifacts
from repro_torch.engine import dispatch as _dispatch
from repro_torch.kernels.lut_matmul import lut_matmul_plain

Mode = Literal["exact", "bitexact", "lowrank", "inject", "fakequant"]

__all__ = ["approx_matmul_int", "approx_matmul", "Mode", "error_moments"]


def error_moments(
    n: int, t: int, fix_to_1: bool = True, dist: str = "gaussian"
) -> tuple[float, float]:
    """(mean, std) of the signed error table — see ``engine.artifacts``."""
    return _artifacts.error_moments(n, t, fix_to_1, dist)


def approx_matmul_int(
    mag_a: torch.Tensor,
    sign_a: torch.Tensor,
    mag_b: torch.Tensor,
    sign_b: torch.Tensor,
    *,
    n: int,
    t: int,
    fix_to_1: bool = True,
) -> torch.Tensor:
    """Bit-exact signed approximate GEMM on integer sign-magnitude operands:
    mag_a (M, K), mag_b (K, N) in [0, 2^n), n <= 8, signs int8; (M, N)
    float32, the exact integer sum converted once (the reference sums in
    float32, exact while |sum| < 2^24)."""
    lut = _artifacts.product_lut_u16(n, t, fix_to_1, mag_a.device)
    return lut_matmul_plain(lut, mag_a, sign_a, mag_b, sign_b, n=n)


def approx_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    n: int = 8,
    t: int = 4,
    fix_to_1: bool = True,
    mode: Mode = "bitexact",
    rank: int = 8,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Real-valued approximate GEMM: x (M, K) @ w (K, N) -> (M, N) f32."""
    return _dispatch.matmul(
        x, w, n=n, t=t, fix_to_1=fix_to_1, mode=mode, rank=rank, generator=generator,
        backend="reference",
    )
