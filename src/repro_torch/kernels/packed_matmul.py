"""Integer GEMM on two int16 K-lanes per 32-bit word (``inject`` body).

Counterpart of ``repro/kernels/packed_matmul.py``.  :func:`pack_i16_pairs`
packs consecutive K values into words (low half = even index, high half =
odd index), padding an odd K with a zero lane.  Words are int32 tensors
holding the reference's uint32 bit patterns (torch has no uint32
arithmetic on the CPU).  :func:`packed_matmul` runs the CUDA kernel
``csrc/packed_matmul.cu`` for CUDA tensors and the plain version
:func:`packed_matmul_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (
    CudaKernel, block_rows, check_operand, wide_accumulator,
)

__all__ = ["KERNEL", "pack_i16_pairs", "packed_matmul", "packed_matmul_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "packed_matmul", "packed_matmul_launch", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
)


def pack_i16_pairs(q: torch.Tensor, *, dim: int) -> torch.Tensor:
    """Pack pairs along ``dim`` of a signed-int tensor into int32 words;
    values must fit int16."""
    q = q.to(torch.int64).movedim(dim, -1)
    if q.shape[-1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    word = (q[..., 0::2] & 0xFFFF) | ((q[..., 1::2] & 0xFFFF) << 16)  # in [0, 2^32)
    word = torch.where(word >= 1 << 31, word - (1 << 32), word)
    return word.to(torch.int32).movedim(-1, dim).contiguous()


def _lanes(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 words -> (even, odd) sign-extended int64 lanes."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    lo, hi = w & 0xFFFF, w >> 16
    return lo - ((lo & 0x8000) << 1), hi - ((hi & 0x8000) << 1)


def packed_matmul_plain(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version.  The lane products and sums are integers
    below 2^53, so float64 products compute them exactly (CUDA has no
    integer matmul); the exact sum is converted to float32 once."""
    a_even, a_odd = _lanes(pa)
    b_even, b_odd = _lanes(pb)
    f64 = torch.float64
    acc = a_even.to(f64) @ b_even.to(f64) + a_odd.to(f64) @ b_odd.to(f64)
    return acc.to(torch.float32)


def packed_matmul(pa: torch.Tensor, pb: torch.Tensor, *, n: int = 15) -> torch.Tensor:
    """Packed (M, K/2) x (K/2, N) -> (M, N) float32 integer GEMM.

    Operands come from :func:`pack_i16_pairs` (``dim=1`` for the left,
    ``dim=0`` for the right).  ``n`` bounds the lane magnitudes
    (|q| <= 2^n - 1, n <= 15) and picks the kernel's accumulator width.
    """
    if not 1 <= n <= 15:
        raise ValueError(f"packed_matmul lanes hold n <= 15 bit magnitudes, got n={n}")
    if pa.device.type == "cpu":
        return packed_matmul_plain(pa, pb)
    dev = pa.device
    m_dim, kw = pa.shape
    n_dim = pb.shape[1]
    check_operand(pa, "pa", torch.int32, (m_dim, kw), dev)
    check_operand(pb, "pb", torch.int32, (kw, n_dim), dev)
    bm = block_rows(m_dim)
    out = torch.empty((m_dim, n_dim), dtype=torch.float32, device=dev)
    wide = wide_accumulator(2 * kw, ((1 << n) - 1) ** 2)
    KERNEL.launch(
        dev, pa.data_ptr(), pb.data_ptr(), out.data_ptr(), m_dim, n_dim, kw, bm, int(wide)
    )
    return out
