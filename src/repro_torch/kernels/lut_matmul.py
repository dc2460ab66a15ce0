"""``bitexact`` GEMM through the approximate-product table.

Counterpart of ``repro/kernels/lut_matmul.py``.  :func:`lut_matmul` runs
the CUDA kernel ``csrc/lut_matmul.cu`` for CUDA tensors and the plain
version :func:`lut_matmul_plain` for CPU tensors; there is no other
fallback.  Both accumulate exact integers and convert to float32 once, so
they are bit-equal at any K (see the kernel's source note for how this
departs from the JAX reference's float32 sums past |sum| = 2^24).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (
    CudaKernel, block_rows, check_operand, wide_accumulator,
)

__all__ = ["KERNEL", "lut_matmul", "lut_matmul_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "lut_matmul", "lut_matmul_launch", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
)

_CHUNK_ELEMS = 1 << 24  # (M, k-chunk, N) gather cube per step of the plain version


def _table_i64(lut: torch.Tensor) -> torch.Tensor:
    """uint16 table -> int64 (through int16, which every backend casts)."""
    return lut.view(torch.int16).to(torch.int64) & 0xFFFF


def lut_matmul_plain(lut, mag_a, sign_a, mag_b, sign_b, *, n: int) -> torch.Tensor:
    """Plain PyTorch version: the same clamped gather and integer sums."""
    qmax = (1 << n) - 1
    table = _table_i64(lut)
    ia = torch.clamp(mag_a.to(torch.int64), max=qmax) << n
    mb = torch.clamp(mag_b.to(torch.int64), max=qmax)
    sa, sb = sign_a.to(torch.int64), sign_b.to(torch.int64)
    m_dim, k_dim = ia.shape
    n_dim = mb.shape[1]
    acc = torch.zeros((m_dim, n_dim), dtype=torch.int64, device=ia.device)
    step = max(1, _CHUNK_ELEMS // max(1, m_dim * n_dim))
    for k0 in range(0, k_dim, step):
        k1 = min(k_dim, k0 + step)
        prod = table[ia[:, k0:k1, None] + mb[None, k0:k1, :]]
        acc += (prod * (sa[:, k0:k1, None] * sb[None, k0:k1, :])).sum(dim=1)
    return acc.to(torch.float32)


def lut_matmul(lut, mag_a, sign_a, mag_b, sign_b, *, n: int = 8) -> torch.Tensor:
    """(M, K) x (K, N) -> (M, N) float32 approximate GEMM.

    lut: (2^(2n),) uint16 product table (``engine.artifacts.product_lut_u16``);
    mag_*: uint8 magnitudes; sign_*: int8 in {-1, 0, 1}; n <= 8.
    """
    if not 1 <= n <= 8:
        raise ValueError(f"lut_matmul supports 1 <= n <= 8, got n={n}")
    if mag_a.device.type == "cpu":
        return lut_matmul_plain(lut, mag_a, sign_a, mag_b, sign_b, n=n)
    dev = mag_a.device
    m_dim, k_dim = mag_a.shape
    n_dim = mag_b.shape[1]
    check_operand(lut, "lut", torch.uint16, (1 << (2 * n),), dev)
    check_operand(mag_a, "mag_a", torch.uint8, (m_dim, k_dim), dev)
    check_operand(sign_a, "sign_a", torch.int8, (m_dim, k_dim), dev)
    check_operand(mag_b, "mag_b", torch.uint8, (k_dim, n_dim), dev)
    check_operand(sign_b, "sign_b", torch.int8, (k_dim, n_dim), dev)
    if lut.data_ptr() % 4:
        raise ValueError("lut must be 4-byte aligned (the kernel copies it as 32-bit words)")
    bm = block_rows(m_dim)
    out = torch.empty((m_dim, n_dim), dtype=torch.float32, device=dev)
    wide = wide_accumulator(k_dim, (1 << (2 * n)) - 1)
    KERNEL.launch(
        dev, lut.data_ptr(), mag_a.data_ptr(), sign_a.data_ptr(), mag_b.data_ptr(),
        sign_b.data_ptr(), out.data_ptr(), m_dim, n_dim, k_dim, n, bm, int(wide),
    )
    return out
