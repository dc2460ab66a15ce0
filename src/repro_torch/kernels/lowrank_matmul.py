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
    CudaKernel, audit_gate, check_operand, pick_tile, sm_count, split_k, tile_counters,
    wide_accumulator,
)

__all__ = [
    "KERNEL", "THREADS", "TILES", "Plan", "audit_body", "audit_trace", "built_launch_plan",
    "launch_plan", "lowrank_matmul", "lowrank_matmul_plain", "max_k_chunk", "smem_bytes", "tile",
    "workspace_bytes",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "lowrank_matmul", "lowrank_matmul_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
)

# csrc/lowrank_matmul.cu: (tokens, weight columns) per block, four warps of
# 16 or 32 tokens by 32 columns; K per stage, ring depth, shared-memory rows
TILES = ((16, 128), (32, 64), (64, 64))
THREADS = 128
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


def built_launch_plan(plan: Plan, m: int, k: int, n_cols: int, n: int, rank: int) -> tuple:
    """(grid, threads, shared memory) of the launch that the built
    ``csrc/lowrank_matmul.cu`` makes for ``plan`` (its
    ``lowrank_matmul_plan``), which ``plan`` must match (grid ``(tiles_n,
    tiles_m, splits)``, :data:`THREADS`, :func:`smem_bytes`); builds the
    library, so it needs ``nvcc``."""
    fn = KERNEL.library().lowrank_matmul_plan
    fn.argtypes = [_I] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    err = fn(m, n_cols, k, n, rank, plan.bm, plan.splits, plan.k_chunk, out)
    if err != 0:
        raise ValueError(f"lowrank_matmul_plan refused {plan} at {(m, k, n_cols, n, rank)}: "
                         f"CUDA error {err}")
    return tuple(out[:3]), out[3], out[4]


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


def audit_body(u, v, mag_a, sign_a, mag_b, sign_b, *, n: int, k_chunk: int,
               clamp: bool = True) -> torch.Tensor:
    """The kernel's arithmetic, carrier by carrier (``csrc/lowrank_matmul.cu``),
    for the certifier.  Exact part: each operand ``s |x|`` as two s8 planes
    ``s h`` and ``s l`` (|x| = 128 h + l), a block's sum over its K slice of
    ``k_chunk`` in int32, the slices summed in int64.  Correction: the
    tables with their zero row (2^n + 1 rows), an entry naming the
    clamped magnitude's row or, for sign 0, the zero row.  Equal to
    :func:`lowrank_matmul_plain` (a zero entry may differ in its sign)."""
    from repro_torch.analysis.carrier import carrier

    cu = "csrc/lowrank_matmul.cu"
    qmax = (1 << n) - 1
    ma, mb = mag_a.to(torch.int64), mag_b.to(torch.int64)
    if clamp:
        ma, mb = torch.clamp(ma, max=qmax), torch.clamp(mb, max=qmax)
    sa, sb = sign_a.to(torch.int64), sign_b.to(torch.int64)
    planes = [(carrier(s * (x >> 7), 8, True, f"{cu}: s8 plane s*h, |x| = 128 h + l"),
               carrier(s * (x & 127), 8, True, f"{cu}: s8 plane s*l"))
              for x, s in ((ma, sa), (mb, sb))]
    (ha, la), (hb, lb) = planes
    prod = (16384 * ha[:, :, None] * hb[None, :, :]
            + 128 * (ha[:, :, None] * lb[None, :, :] + la[:, :, None] * hb[None, :, :])
            + la[:, :, None] * lb[None, :, :])
    m_dim, k_dim, n_dim = prod.shape
    slices = -(-k_dim // k_chunk)
    if slices * k_chunk > k_dim:
        prod = torch.cat([prod, prod.new_zeros((m_dim, slices * k_chunk - k_dim, n_dim))], 1)
    part = carrier(prod.reshape(m_dim, slices, k_chunk, n_dim).sum(dim=2), 32, True,
                   f"{cu}: a block's int32 partial over its K slice (max_k_chunk)")
    exact = carrier(part.sum(dim=1), 64, True, f"{cu}: the split-K partials summed in int64")
    zero = u.new_zeros((1, u.shape[1]))
    ia = torch.where(sa == 0, 1 << n, ma)
    ib = torch.where(sb == 0, 1 << n, mb)
    ue = torch.cat([u, zero])[ia] * sign_a.to(torch.float32)[..., None]
    ve = torch.cat([v, zero])[ib] * sign_b.to(torch.float32)[..., None]
    rank = u.shape[1]
    ue = ue.reshape(m_dim, k_dim * rank)
    ve = ve.permute(0, 2, 1).reshape(k_dim * rank, n_dim)
    return exact.to(torch.float32) + ue @ ve


def audit_trace(*, n: int, t: int = 4, rank: int = 8, m: int = 16, k: int | None = None,
                n_cols: int = 32, k_chunk: int | None = None):
    """The certifier's contract of the kernel (nothing executes): uint8
    magnitudes over their whole carrier (the clamp is what keeps the
    tables' gathers in bounds), signs in {-1, 0, 1}, K two slices of the
    longest int32-exact slice (:func:`max_k_chunk`); ``t`` shapes only the
    tables' contents."""
    from repro_torch.analysis.spec import TraceSpec, ValueRange, sds

    del t
    k_chunk = max_k_chunk(n) if k_chunk is None else k_chunk
    k = 2 * k_chunk if k is None else k
    sgn = ValueRange.sign()
    return TraceSpec(
        name=f"kernel:lowrank_matmul[n={n},r={rank},K={k},slice={k_chunk}]",
        fn=lambda u, v, ma, sa, mb, sb: audit_body(u, v, ma, sa, mb, sb, n=n, k_chunk=k_chunk),
        args=[sds((1 << n, rank), torch.float32), sds((1 << n, rank), torch.float32),
              sds((m, k), torch.uint8), sds((m, k), torch.int8), sds((k, n_cols), torch.uint8),
              sds((k, n_cols), torch.int8)],
        ranges=[None, None, None, sgn, None, sgn],
        exact_products=False,
        facts={"k": k, "k_chunk": k_chunk},
    )


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
    audit_gate(KERNEL.name, "lowrank_gemm", n, max(1, n // 2))
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
