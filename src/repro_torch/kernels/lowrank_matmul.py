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
below 2^24 (K <= 256 at n = 8).  The kernel runs the exact part on the
int8 tensor cores and the correction as three TF32 products on them; it
splits K over blocks at small M (:func:`launch_plan`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.build import (
    CudaKernel, check_operand, pick_tile, sm_count, split_k, tile_counters, wide_accumulator,
)

__all__ = [
    "KERNEL", "TILES", "Plan", "launch_plan", "lowrank_matmul", "lowrank_matmul_plain",
    "max_k_chunk", "smem_bytes", "tile", "workspace_bytes",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "lowrank_matmul", "lowrank_matmul_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
)

# csrc/lowrank_matmul.cu: (tokens, weight columns) per block, four warps of
# 16 or 32 tokens by 32 columns; K per stage, ring depth, shared-memory rows
TILES = ((16, 128), (32, 64), (64, 64))
K_STEP, STAGES = 32, 3
RAW_TOKEN_ROW, WEIGHT_PLANE_ROW, TOKEN_PLANE_ROW = 48, 40, 32
MIN_K_CHUNK = 64  # the shortest K slice a split gives a block


class Plan(NamedTuple):
    """One launch: the (bm, bn) block tile and K cut into ``splits`` slices
    of ``k_chunk``."""

    bm: int
    bn: int
    splits: int
    k_chunk: int


def max_k_chunk(n: int) -> int:
    """The longest K slice whose int32 sum is exact:
    ``K_slice * (2^n - 1)^2 < 2^31``, in whole stages."""
    qmax_sq = ((1 << n) - 1) ** 2
    chunk = ((1 << 31) - 1) // qmax_sq // K_STEP * K_STEP
    assert not wide_accumulator(chunk, qmax_sq)
    return chunk


def tile(m: int) -> tuple[int, int]:
    """The kernel's (tokens, weight columns) block tile for ``m`` rows."""
    return pick_tile(m, TILES)


@functools.lru_cache(maxsize=4096)
def launch_plan(m: int, k: int, n_cols: int, n: int, sms: int = 132) -> Plan:
    """The kernel's tile and split for an (m, k) x (k, n_cols) call at bit
    width ``n`` on a card with ``sms`` SMs."""
    bm, bn = tile(m)
    tiles = -(-m // bm) * -(-n_cols // bn)
    splits, chunk = split_k(tiles, k, step=K_STEP, min_chunk=MIN_K_CHUNK,
                            max_chunk=max_k_chunk(n), sms=sms)
    return Plan(bm, bn, splits, chunk)


def workspace_bytes(plan: Plan, m: int, n_cols: int) -> int:
    """Bytes of the split-K workspace: an int32 partial and a float32
    correction per split and output; none without a split."""
    return 0 if plan.splits == 1 else plan.splits * m * n_cols * 8


def smem_bytes(n: int, bm: int, rank: int) -> int:
    """Dynamic shared memory of one block at token tile ``bm``: both tables
    as (hi, lo) float pairs (2^n rows and a zero row, rank rounded up to 8),
    the cp.async ring of magnitude and sign tiles, the int8 plane tiles and
    the uint16 table entries of one stage."""
    bn = dict(TILES)[bm]
    r8 = -(-rank // 8) * 8
    stage = 2 * K_STEP * bn + 2 * bm * RAW_TOKEN_ROW
    planes = 2 * bn * WEIGHT_PLANE_ROW + 2 * bm * TOKEN_PLANE_ROW
    entries = 2 * K_STEP * (bn + bm)
    return 16 * ((1 << n) + 1) * r8 + STAGES * stage + planes + entries


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
    plan = launch_plan(m_dim, k_dim, n_dim, n, sm_count(dev))
    out = torch.empty((m_dim, n_dim), dtype=torch.float32, device=dev)
    ws_int = ws_corr = counters = None
    if plan.splits > 1:
        ws = torch.empty(workspace_bytes(plan, m_dim, n_dim) // 4, dtype=torch.int32, device=dev)
        ws_int = ws.data_ptr()  # int32 partials, then the float32 corrections
        ws_corr = ws_int + plan.splits * m_dim * n_dim * 4
        counters = tile_counters(dev, -(-m_dim // plan.bm) * -(-n_dim // plan.bn)).data_ptr()
    operands = (mag_a, sign_a, mag_b, sign_b)
    vec = k_dim % 16 == 0 and n_dim % 16 == 0 and all(x.data_ptr() % 16 == 0 for x in operands)
    KERNEL.launch(
        dev, u.data_ptr(), v.data_ptr(), *(x.data_ptr() for x in operands), out.data_ptr(),
        ws_int, ws_corr, counters, m_dim, n_dim, k_dim, n, rank, plan.bm, plan.splits,
        plan.k_chunk, int(vec),
    )
    return out
