"""Compatibility shim over ``repro_torch.engine`` (the old kernel entry points).

Counterpart of ``repro/kernels/ops.py``, whose wrappers pin the Pallas
kernels (native on the TPU, interpret mode elsewhere).  Here they pin the
CUDA kernels for CUDA tensors and the plain versions for CPU tensors.  The
reference's ``use_interpret`` re-export has no counterpart.  New code
calls ``repro_torch.engine.matmul`` / ``repro_torch.engine.multiply``.
"""

from __future__ import annotations

import torch

from repro_torch.core.seqmul import operands
from repro_torch.engine import dispatch as _engine

__all__ = ["approx_multiply", "approx_matmul_kernel"]


def _pinned(x: torch.Tensor) -> str:
    return "cuda" if x.device.type == "cuda" else "reference"


def approx_multiply(a, b, *, n: int = 8, t: int = 4, fix_to_1: bool = True) -> torch.Tensor:
    """Elementwise approximate product of integer magnitudes, packed in
    uint32: ``engine.multiply`` pinned to the ``seqmul_packed`` kernel on a
    CUDA tensor and to the reference body on a CPU tensor."""
    a, b = operands(a, b)
    return _engine.multiply(a, b, n=n, t=t, approx=True, fix_to_1=fix_to_1, backend=_pinned(a))


def approx_matmul_kernel(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    n: int = 8,
    t: int = 4,
    fix_to_1: bool = True,
    mode: str = "bitexact",
    rank: int = 8,
) -> torch.Tensor:
    """f32 (M, K) @ (K, N) with approximate products: the CUDA kernels for
    CUDA tensors, the reference bodies for CPU tensors."""
    if mode not in ("bitexact", "lowrank"):
        raise ValueError(f"kernel modes are 'bitexact' | 'lowrank', got {mode!r}")
    return _engine.matmul(
        x, w, n=n, t=t, fix_to_1=fix_to_1, mode=mode, rank=rank, backend=_pinned(x)
    )
