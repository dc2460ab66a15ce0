"""``lowrank`` GEMM: the exact product plus the rank-r SVD error correction.

Counterpart of ``repro/kernels/lowrank_matmul.py``.  :func:`lowrank_matmul`
runs the CUDA kernel ``csrc/lowrank_matmul.cu`` for CUDA tensors and the
plain version :func:`lowrank_matmul_plain` for CPU tensors; there is no
other fallback.  The kernel gathers ``U[|a|]`` and ``V[|b|]`` from the two
(2^n, r) tables itself, where the reference gathers the embeddings into
device memory first; the function is the same.

Both versions sum the exact part ``sum_k a*b`` as an integer and convert
it once (the port's rule for its integer GEMMs), and add the correction
``sum_k sum_r (sa U[|a|]) (sb V[|b|])`` summed in float32.  The reference
sums the exact part in float32, which is the same number while it stays
below 2^24 (K <= 256 at n = 8).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (
    CudaKernel, block_rows, check_operand, wide_accumulator,
)

__all__ = ["KERNEL", "lowrank_matmul", "lowrank_matmul_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "lowrank_matmul", "lowrank_matmul_launch",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
)


def lowrank_matmul_plain(u, v, mag_a, sign_a, mag_b, sign_b, *, n: int) -> torch.Tensor:
    """Plain PyTorch version: the same clamped gathers and the same split
    (exact integer part converted once, float32 correction added)."""
    qmax = (1 << n) - 1
    ma = torch.clamp(mag_a.to(torch.int64), max=qmax)
    mb = torch.clamp(mag_b.to(torch.int64), max=qmax)
    sa, sb = sign_a.to(torch.float32), sign_b.to(torch.float32)
    # integers below 2^53: float64 products and sums are exact on every device
    exact = ((ma * sign_a.to(torch.int64)).to(torch.float64)
             @ (mb * sign_b.to(torch.int64)).to(torch.float64)).to(torch.float32)
    m_dim, k_dim = ma.shape
    n_dim, rank = mb.shape[1], u.shape[1]
    ue = (u[ma] * sa[..., None]).reshape(m_dim, k_dim * rank)  # (M, K*r)
    ve = (v[mb] * sb[..., None]).permute(0, 2, 1).reshape(k_dim * rank, n_dim)  # (K*r, N)
    return exact + ue @ ve


def lowrank_matmul(u, v, mag_a, sign_a, mag_b, sign_b, *, n: int = 8) -> torch.Tensor:
    """(M, K) x (K, N) -> (M, N) float32 ``lowrank`` GEMM.

    u, v: (2^n, r) float32 SVD factors (``engine.artifacts.svd_factors``);
    mag_*: uint8 magnitudes; sign_*: int8 in {-1, 0, 1}; n <= 8.
    """
    if not 1 <= n <= 8:
        raise ValueError(f"lowrank_matmul supports 1 <= n <= 8, got n={n}")
    if mag_a.device.type == "cpu":
        return lowrank_matmul_plain(u, v, mag_a, sign_a, mag_b, sign_b, n=n)
    dev = mag_a.device
    m_dim, k_dim = mag_a.shape
    n_dim = mag_b.shape[1]
    rank = u.shape[1]
    check_operand(u, "u", torch.float32, (1 << n, rank), dev)
    check_operand(v, "v", torch.float32, (1 << n, rank), dev)
    check_operand(mag_a, "mag_a", torch.uint8, (m_dim, k_dim), dev)
    check_operand(sign_a, "sign_a", torch.int8, (m_dim, k_dim), dev)
    check_operand(mag_b, "mag_b", torch.uint8, (k_dim, n_dim), dev)
    check_operand(sign_b, "sign_b", torch.int8, (k_dim, n_dim), dev)
    out = torch.empty((m_dim, n_dim), dtype=torch.float32, device=dev)
    wide = wide_accumulator(k_dim, ((1 << n) - 1) ** 2)
    KERNEL.launch(
        dev, u.data_ptr(), v.data_ptr(), mag_a.data_ptr(), sign_a.data_ptr(),
        mag_b.data_ptr(), sign_b.data_ptr(), out.data_ptr(), m_dim, n_dim, k_dim, n, rank,
        block_rows(m_dim), int(wide),
    )
    return out
