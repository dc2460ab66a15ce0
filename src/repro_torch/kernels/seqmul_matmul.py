"""The split-word recurrence itself as a GEMM (``seqmul`` mode, n <= 12).

Counterpart of ``repro/kernels/seqmul_matmul.py``.  :func:`seqmul_matmul`
runs the CUDA kernel ``csrc/seqmul_matmul.cu`` for CUDA tensors and the
plain version :func:`seqmul_matmul_plain` for CPU tensors.  The plain
version runs ``engine.recurrence.seqmul_recurrence`` on K-chunks of the
(M, K, N) outer-product cube; the kernel runs the same recurrence per
product in registers.  Both sum exact integers and convert once.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.engine.recurrence import pack_u32, seqmul_recurrence, validate_nt
from repro_torch.kernels.build import (
    CudaKernel, block_rows, check_operand, wide_accumulator,
)

__all__ = ["KERNEL", "MAX_N", "seqmul_matmul", "seqmul_matmul_plain"]

MAX_N = 12
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "seqmul_matmul", "seqmul_matmul_launch",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
)

_CHUNK_ELEMS = 1 << 23  # (M, k-chunk, N) recurrence cube per step of the plain version


def _check_nt(n: int, t: int) -> None:
    validate_nt(n, t)
    if n > MAX_N:
        raise ValueError(f"seqmul_matmul supports n <= {MAX_N}, got n={n}")


def seqmul_matmul_plain(mag_a, sign_a, mag_b, sign_b, *, n: int, t: int,
                        approx: bool = True, fix_to_1: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the recurrence on the outer-product cube."""
    _check_nt(n, t)
    a = mag_a.to(torch.int64)
    b = mag_b.to(torch.int64)
    sa, sb = sign_a.to(torch.int64), sign_b.to(torch.int64)
    m_dim, k_dim = a.shape
    n_dim = b.shape[1]
    acc = torch.zeros((m_dim, n_dim), dtype=torch.int64, device=a.device)
    step = max(1, _CHUNK_ELEMS // max(1, m_dim * n_dim))
    for k0 in range(0, k_dim, step):
        k1 = min(k_dim, k0 + step)
        shape = (m_dim, k1 - k0, n_dim)
        lo, s_lsp, s_msp, _ = seqmul_recurrence(
            a[:, k0:k1, None].expand(shape), b[None, k0:k1, :].expand(shape),
            n=n, t=t, approx=approx, fix_to_1=fix_to_1,
        )
        prod = pack_u32(lo, s_lsp, s_msp, n=n, t=t)
        acc += (prod * (sa[:, k0:k1, None] * sb[None, k0:k1, :])).sum(dim=1)
    return acc.to(torch.float32)


def seqmul_matmul(mag_a, sign_a, mag_b, sign_b, *, n: int, t: int,
                  approx: bool = True, fix_to_1: bool = True) -> torch.Tensor:
    """(M, K) x (K, N) -> (M, N) float32 GEMM, the recurrence per product.

    mag_*: int16 magnitudes in [0, 2^n); sign_*: int8 in {-1, 0, 1}.
    """
    _check_nt(n, t)
    if mag_a.device.type == "cpu":
        return seqmul_matmul_plain(mag_a, sign_a, mag_b, sign_b, n=n, t=t,
                                   approx=approx, fix_to_1=fix_to_1)
    dev = mag_a.device
    m_dim, k_dim = mag_a.shape
    n_dim = mag_b.shape[1]
    check_operand(mag_a, "mag_a", torch.int16, (m_dim, k_dim), dev)
    check_operand(sign_a, "sign_a", torch.int8, (m_dim, k_dim), dev)
    check_operand(mag_b, "mag_b", torch.int16, (k_dim, n_dim), dev)
    check_operand(sign_b, "sign_b", torch.int8, (k_dim, n_dim), dev)
    bm = block_rows(m_dim)
    out = torch.empty((m_dim, n_dim), dtype=torch.float32, device=dev)
    wide = wide_accumulator(k_dim, (1 << (2 * n)) - 1)
    KERNEL.launch(
        dev, mag_a.data_ptr(), sign_a.data_ptr(), mag_b.data_ptr(), sign_b.data_ptr(),
        out.data_ptr(), m_dim, n_dim, k_dim, n, t, int(approx), int(fix_to_1), bm, int(wide),
    )
    return out
