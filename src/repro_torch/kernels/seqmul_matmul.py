"""The split-word recurrence itself as a GEMM (``seqmul`` mode, n <= 12).

Counterpart of ``repro/kernels/seqmul_matmul.py``.  :func:`seqmul_matmul`
runs the CUDA kernel ``csrc/seqmul_matmul.cu`` for CUDA tensors and the
plain version :func:`seqmul_matmul_plain` for CPU tensors.  The plain
version runs ``engine.recurrence.seqmul_recurrence`` on K-chunks of the
(M, K, N) outer-product cube; the kernel runs the same recurrence
bit-sliced, 32 values of k to a word, and splits K over blocks at small M
(:func:`launch_plan`).  Both sum exact integers and convert once; with
``integer=True`` both return the sums themselves, int32 (int64 past
:func:`int32_k_limit`): the integer epilogue of a tensor-parallel K shard,
whose sums the shards add as integers before converting once
(``engine/modes.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.engine.recurrence import pack_u32, seqmul_recurrence, validate_nt
from repro_torch.kernels.build import (
    CudaKernel, audit_gate, check_operand, device_index, pick_tile, sm_count_of, split_k,
    tile_counters, wide_accumulator, workspace_bytes,
)

__all__ = [
    "KERNEL", "MAX_N", "THREADS", "TILES", "Plan", "audit_body", "audit_trace",
    "built_launch_plan", "int32_k_limit", "int_dtype", "launch_plan", "seqmul_matmul",
    "seqmul_matmul_plain",
    "smem_bytes", "tile",
]

MAX_N = 12
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "seqmul_matmul", "seqmul_matmul_launch",
    [_P] * 5 + [_I] * 12 + [_P, _P, _I, _I, _P],
)

# csrc/seqmul_matmul.cu: (rows, columns) per block of eight warps, one
# column and one or two rows per thread; K words of 32 lanes per stage
TILES = ((2, 128), (4, 64), (8, 32), (16, 32))
THREADS = 256
STAGE_WORDS = 4
STAGE_K = 32 * STAGE_WORDS

_CHUNK_ELEMS = 1 << 23  # (M, k-chunk, N) recurrence cube per step of the plain version


class Plan(NamedTuple):
    """One launch: the (bm, bn) block tile, K cut into ``splits`` slices of
    ``k_chunk``, the grid, threads and shared memory, and the bytes of the
    split-K workspace (0 without a split), whose partials are int64 when
    ``wide``."""

    bm: int
    bn: int
    splits: int
    k_chunk: int
    grid: tuple
    threads: int
    smem: int
    workspace: int
    wide: bool


def tile(m: int) -> tuple[int, int]:
    """The kernel's (rows, columns) block tile for ``m`` rows: the smallest
    row tile that holds them, else the largest."""
    return pick_tile(m, TILES)


def smem_bytes(n: int, bm: int, bn: int) -> int:
    """Shared memory of one block: the A planes, n + 2 per (row, K word)
    rounded up to whole 16-byte words, and the B planes, n + 2 per
    (K word, column)."""
    a_stride = (n + 2 + 3) // 4 * 4
    return 4 * (bm * STAGE_WORDS * a_stride + STAGE_WORDS * (n + 2) * bn)


def launch_plan(m: int, k: int, n_cols: int, n: int, sms: int = 132) -> Plan:
    """The launch of an (m, k) x (k, n_cols) call at bit width ``n`` on a
    card with ``sms`` SMs: tiles x splits fill one wave of two blocks per
    SM where K allows.  Any slice length is exact: the per-plane counts
    are bounded by K, and the cross-block sums are int64 where
    :func:`wide_accumulator` says so on the whole K."""
    bm, bn = tile(m)
    tiles_n, tiles_m = -(-n_cols // bn), -(-m // bm)
    splits, chunk = split_k(tiles_n * tiles_m, k, step=STAGE_K, min_chunk=STAGE_K, sms=sms)
    wide = wide_accumulator(k, (1 << (2 * n)) - 1)
    return Plan(bm, bn, splits, chunk, (tiles_n, tiles_m, splits), THREADS,
                smem_bytes(n, bm, bn), workspace_bytes(splits, m, n_cols, wide), wide)


@functools.lru_cache(maxsize=4096)
def _plan_on(index: int, m: int, k: int, n_cols: int, n: int) -> Plan:
    """:func:`launch_plan` on CUDA device ``index``, once per shape."""
    return launch_plan(m, k, n_cols, n, sm_count_of(index))


def built_launch_plan(plan: Plan, m: int, k: int, n_cols: int, n: int, t: int) -> tuple:
    """(grid, threads, shared memory) of the launch that the built
    ``csrc/seqmul_matmul.cu`` makes for ``plan`` (its
    ``seqmul_matmul_plan``), which ``plan`` must equal; builds the
    library, so it needs ``nvcc``."""
    fn = KERNEL.library().seqmul_matmul_plan
    fn.argtypes = [_I] * 9 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    err = fn(m, n_cols, k, n, t, plan.bm, plan.bn, plan.splits, plan.k_chunk, out)
    if err != 0:
        raise ValueError(f"seqmul_matmul_plan refused {plan} at {(m, k, n_cols, n, t)}: "
                         f"CUDA error {err}")
    return tuple(out[:3]), out[3], out[4]


def _check_nt(n: int, t: int) -> None:
    validate_nt(n, t)
    if n > MAX_N:
        raise ValueError(f"seqmul_matmul supports n <= {MAX_N}, got n={n}")


def int_dtype(k: int, n: int) -> torch.dtype:
    """The integer epilogue's dtype at K = ``k``: the cross-block partial's,
    int32 up to :func:`int32_k_limit`, else int64."""
    return torch.int64 if wide_accumulator(k, (1 << (2 * n)) - 1) else torch.int32


def seqmul_matmul_plain(mag_a, sign_a, mag_b, sign_b, *, n: int, t: int,
                        approx: bool = True, fix_to_1: bool = True,
                        integer: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the recurrence on the outer-product cube;
    ``integer`` returns the sums in :func:`int_dtype`."""
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
    return acc.to(int_dtype(k_dim, n) if integer else torch.float32)


def _recurrence_carriers(a, b, *, n: int, t: int, approx: bool, fix_to_1: bool,
                         carry_weight: int = 1):
    """``engine.recurrence.seqmul_recurrence`` line for line, each word
    marked with the planes ``csrc/seqmul_matmul.cu`` holds it in: the state
    W = s_lsp + 2^t s_msp is n + 1 planes (``w[NB + 1]``), s_lsp planes
    0..t-1 and s_msp planes t..n; lo is n - 1 planes.  ``carry_weight``
    scales the carry into the MSP word (1 in the paper's design; 2 is a
    mutation the tests hold the certifier to).  Returns the assembled
    product."""
    from repro_torch.analysis.carrier import carrier

    cu = "csrc/seqmul_matmul.cu"
    m_t = (1 << t) - 1
    zero = torch.zeros_like(a)
    s_lsp, s_msp, c_ff, lo = zero, zero, zero, zero
    for j in range(n):
        m = torch.where(((b >> j) & 1).bool(), a, zero)
        aug_lsp = (s_lsp >> 1) | ((s_msp & 1) << (t - 1))
        aug_msp = s_msp >> 1
        lsum = aug_lsp + (m & m_t)
        c_out = lsum >> t
        c_in = c_ff if approx else c_out
        s_msp = carrier(aug_msp + (m >> t) + carry_weight * c_in, n - t + 1, False,
                        f"{cu}: w[t..n], the state's MSP planes (s_msp)")
        lo = lo | ((lsum & 1) << j)
        s_lsp = carrier(lsum & m_t, t, False, f"{cu}: w[0..t-1], the state's LSP planes (s_lsp)")
        c_ff = c_out
    lo = lo & ((1 << (n - 1)) - 1) if n > 1 else zero
    if approx and fix_to_1:
        hit = c_ff.bool()
        lo = torch.where(hit, torch.full_like(lo, (1 << (n - 1)) - 1 if n > 1 else 0), lo)
        s_lsp = torch.where(hit, torch.full_like(s_lsp, m_t), s_lsp)
        s_msp = torch.where(hit, s_msp | 1, s_msp)
    lo = carrier(lo, max(n - 1, 1), False, f"{cu}: lo[], product planes 0..n-2")
    w = carrier(s_lsp + (s_msp << t), n + 1, False, f"{cu}: w[NB + 1], the state W")
    return carrier(lo + (w << (n - 1)), 2 * n, False,
                   f"{cu}: the 2n product planes counted (count[2 * NB])")


def audit_body(mag_a, sign_a, mag_b, sign_b, *, n: int, t: int, wide: bool,
               approx: bool = True, fix_to_1: bool = True, carry_weight: int = 1,
               integer: bool = False):
    """The kernel's arithmetic, carrier by carrier (``csrc/seqmul_matmul.cu``),
    for the certifier: int64 values, each marked with the word the kernel
    holds it in (``analysis.carrier``).  Bit-equal to
    :func:`seqmul_matmul_plain` (``carry_weight`` 1).  The recurrence's
    words and its 2n product planes (:func:`_recurrence_carriers`); per
    plane p a signed popcount sum over the K slice in int32 (``count[p]``);
    the slice's ``sum_p count_p 2^p`` in int64 (``part``); the partial
    that crosses blocks in int32 (``wide`` False) or int64, which
    ``integer`` returns as the output in place of its float32 value."""
    from repro_torch.analysis.carrier import carrier

    cu = "csrc/seqmul_matmul.cu"
    a, b = mag_a.to(torch.int64), mag_b.to(torch.int64)
    m_dim, k_dim = a.shape
    n_dim = b.shape[1]
    shape = (m_dim, k_dim, n_dim)
    prod = _recurrence_carriers(a[:, :, None].expand(shape), b[None, :, :].expand(shape), n=n,
                                t=t, approx=approx, fix_to_1=fix_to_1,
                                carry_weight=carry_weight)
    sign = sign_a.to(torch.int64)[:, :, None] * sign_b.to(torch.int64)[None, :, :]
    part = torch.zeros((m_dim, n_dim), dtype=torch.int64, device=a.device)
    for p in range(2 * n):
        count = carrier((((prod >> p) & 1) * sign).sum(dim=1), 32, True,
                        f"{cu}: count[p], a plane's signed popcounts over the K slice")
        part = part + (count << p)
    part = carrier(part, 64, True, f"{cu}: part, the slice's sum")
    part = carrier(part, 64 if wide else 32, True,
                   f"{cu}: the split-K partial ({'int64' if wide else 'int32'} by "
                   f"build.wide_accumulator)")
    return part if integer else part.to(torch.float32)


def int32_k_limit(n: int) -> int:
    """The largest K whose partials :func:`launch_plan` keeps in int32."""
    return ((1 << 31) - 1) // ((1 << (2 * n)) - 1)


def audit_trace(*, n: int, t: int, m: int = 2, k: int | None = None, n_cols: int = 32,
                wide: bool | None = None, carry_weight: int = 1, integer: bool = False):
    """The certifier's contract of the kernel (nothing executes), past the
    wrapper's ``n <= 12`` guard so the carriers' own frontier is derived:
    int16 magnitudes in ``[0, 2^n - 1]``, signs in {-1, 0, 1}; K the
    largest whose partials stay int32 (:func:`int32_k_limit`)."""
    from repro_torch.analysis.spec import TraceSpec, ValueRange, sds

    k = max(1, int32_k_limit(n)) if k is None else k
    wide = wide_accumulator(k, (1 << (2 * n)) - 1) if wide is None else wide
    q, sgn = ValueRange.quantized(n), ValueRange.sign()
    return TraceSpec(
        name=f"kernel:seqmul_matmul[n={n},t={t},K={k}{',wide' if wide else ''}"
             f"{',int' if integer else ''}]",
        fn=lambda ma, sa, mb, sb: audit_body(ma, sa, mb, sb, n=n, t=t, wide=wide,
                                             carry_weight=carry_weight, integer=integer),
        args=[sds((m, k), torch.int16), sds((m, k), torch.int8), sds((k, n_cols), torch.int16),
              sds((k, n_cols), torch.int8)],
        ranges=[q, sgn, q, sgn],
        facts={"k": k, "wide": wide},
    )


def seqmul_matmul(mag_a, sign_a, mag_b, sign_b, *, n: int, t: int,
                  approx: bool = True, fix_to_1: bool = True,
                  integer: bool = False) -> torch.Tensor:
    """(M, K) x (K, N) -> (M, N) float32 GEMM, the recurrence per product, or
    with ``integer`` its exact sums in :func:`int_dtype` (the integer epilogue).

    mag_*: int16 magnitudes in [0, 2^n); sign_*: int8 in {-1, 0, 1} (the
    kernel reads magnitude bits 0..n-1 and a sign's bits 0 and 7 only).
    """
    _check_nt(n, t)
    if mag_a.device.type == "cpu":
        return seqmul_matmul_plain(mag_a, sign_a, mag_b, sign_b, n=n, t=t,
                                   approx=approx, fix_to_1=fix_to_1, integer=integer)
    dev = mag_a.device
    m_dim, k_dim = mag_a.shape
    n_dim = mag_b.shape[1]
    check_operand(mag_a, "mag_a", torch.int16, (m_dim, k_dim), dev)
    check_operand(sign_a, "sign_a", torch.int8, (m_dim, k_dim), dev)
    check_operand(mag_b, "mag_b", torch.int16, (k_dim, n_dim), dev)
    check_operand(sign_b, "sign_b", torch.int8, (k_dim, n_dim), dev)
    audit_gate(KERNEL.name, "seqmul_gemm_int" if integer else "seqmul_gemm", n, t)
    index = device_index(dev)
    plan = _plan_on(index, m_dim, k_dim, n_dim, n)
    dtype = (torch.int64 if plan.wide else torch.int32) if integer else torch.float32
    out = torch.empty((m_dim, n_dim), dtype=dtype, device=dev)
    ws_ptr = counters = None
    if plan.splits > 1:
        ws = torch.empty(plan.workspace, dtype=torch.uint8, device=dev)
        ws_ptr = ws.data_ptr()
        counters = tile_counters(dev, plan.grid[0] * plan.grid[1]).data_ptr()
    KERNEL.launch(
        dev, mag_a.data_ptr(), sign_a.data_ptr(), mag_b.data_ptr(), sign_b.data_ptr(),
        out.data_ptr(), m_dim, n_dim, k_dim, n, t, int(approx), int(fix_to_1), plan.bm,
        int(plan.wide), plan.bn, plan.splits, plan.k_chunk, ws_ptr, counters, int(integer),
    )
    return out
