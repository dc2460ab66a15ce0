"""``bitexact`` GEMM through the approximate-product table.

Counterpart of ``repro/kernels/lut_matmul.py``.  :func:`lut_matmul` runs
the CUDA kernel ``csrc/lut_matmul.cu`` for CUDA tensors and the plain
version :func:`lut_matmul_plain` for CPU tensors; there is no other
fallback.  Both accumulate exact integers and convert to float32 once, so
they are bit-equal at any K (see the kernel's source note for how this
departs from the JAX reference's float32 sums past |sum| = 2^24).  With
``integer=True`` both return those exact sums themselves, int32 (int64
past :func:`int32_k_limit`), in place of the float32 conversion: the
integer epilogue of a tensor-parallel K shard, whose sums the shards add
as integers before converting once (``engine/modes.py``).  The
kernel is a persistent grid of one block per SM that copies the table
into shared memory once and walks (row tile, column tile, K slice) work
items (:func:`launch_plan`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.build import (
    CudaKernel, audit_gate, check_operand, device_index, pick_tile, sm_count_of, split_k,
    tile_counters, wide_accumulator, workspace_bytes,
)

__all__ = [
    "KERNEL", "TILES", "THREADS", "Plan", "audit_body", "audit_trace", "built_launch_plan",
    "int32_k_limit", "int_dtype", "launch_plan", "lut_matmul", "lut_matmul_plain", "smem_bytes", "tile",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "lut_matmul", "lut_matmul_launch", [_P] * 6 + [_I] * 10 + [_P, _P, _I, _I, _P]
)

# csrc/lut_matmul.cu: row tiles of 512 columns for a 512-thread block (4
# rows x 1 column, 8 x 2 and 8 x 4 per thread); K per stage
BN = 512
TILES = ((4, BN), (16, BN), (32, BN))
THREADS = 512
STAGE_K = 32
MIN_K_CHUNK = 64  # the shortest K slice a split gives a work item
MAX_ROUND_SPLITS = 4  # the most slices that even out the rounds of many tiles

_CHUNK_ELEMS = 1 << 24  # (M, k-chunk, N) gather cube per step of the plain version


class Plan(NamedTuple):
    """One launch: the row tile, K cut into ``splits`` slices of
    ``k_chunk``, the persistent grid (one block per SM, at most one per
    work item), threads and shared memory, the work items and the bytes of
    the split-K workspace (0 without a split), whose partials are int64
    when ``wide``."""

    bm: int
    splits: int
    k_chunk: int
    grid: tuple
    threads: int
    smem: int
    items: int
    workspace: int
    wide: bool


def tile(m: int) -> tuple[int, int]:
    """The kernel's (rows, columns) tile for ``m`` rows: the smallest row
    tile that holds them, else the largest."""
    return pick_tile(m, TILES)


def smem_bytes(n: int, bm: int) -> int:
    """Shared memory of one block: the uint16 table (rounded up to whole
    16-byte words) and one word per (k, column) and per (k, row) of a
    stage."""
    table = -(-(2 << (2 * n)) // 16) * 16
    return table + 4 * STAGE_K * (BN + bm)


def launch_plan(m: int, k: int, n_cols: int, n: int, sms: int = 132) -> Plan:
    """The launch of an (m, k) x (k, n_cols) call at bit width ``n`` on a
    card with ``sms`` SMs: K is split as far as the work items fill one
    block per SM and slices of :data:`MIN_K_CHUNK` allow.  With more tiles
    than SMs, K is cut into the fewest slices (at most
    :data:`MAX_ROUND_SPLITS`) that need the fewest rounds of work per
    tile's worth: 192 tiles on 132 SMs take two rounds whole, three rounds
    of half items cut in two."""
    bm, bn = tile(m)
    tiles = -(-m // bm) * -(-n_cols // bn)
    if tiles > sms:
        want = min(range(1, MAX_ROUND_SPLITS + 1), key=lambda s: -(-tiles * s // sms) / s)
        splits, chunk = split_k(1, k, step=STAGE_K, min_chunk=MIN_K_CHUNK, sms=want, per_sm=1)
    else:
        splits, chunk = split_k(tiles, k, step=STAGE_K, min_chunk=MIN_K_CHUNK, sms=sms,
                                per_sm=1)
    items = tiles * splits
    wide = wide_accumulator(k, (1 << (2 * n)) - 1)
    return Plan(bm, splits, chunk, (min(items, sms), 1, 1), THREADS, smem_bytes(n, bm), items,
                workspace_bytes(splits, m, n_cols, wide), wide)


@functools.lru_cache(maxsize=4096)
def _plan_on(index: int, m: int, k: int, n_cols: int, n: int) -> tuple[Plan, int]:
    """:func:`launch_plan` on CUDA device ``index`` and its SM count, once
    per shape."""
    sms = sm_count_of(index)
    return launch_plan(m, k, n_cols, n, sms), sms


def built_launch_plan(plan: Plan, m: int, k: int, n_cols: int, n: int, sms: int) -> tuple:
    """(grid, threads, shared memory) of the launch that the built
    ``csrc/lut_matmul.cu`` makes for ``plan`` (its ``lut_matmul_plan``),
    which ``plan`` must equal; builds the library, so it needs ``nvcc``."""
    fn = KERNEL.library().lut_matmul_plan
    fn.argtypes = [_I] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    err = fn(m, n_cols, k, n, plan.bm, plan.splits, plan.k_chunk, sms, out)
    if err != 0:
        raise ValueError(f"lut_matmul_plan refused {plan} at {(m, k, n_cols, n)}: "
                         f"CUDA error {err}")
    return tuple(out[:3]), out[3], out[4]


def _table_i64(lut: torch.Tensor) -> torch.Tensor:
    """uint16 table -> int64 (through int16, which every backend casts)."""
    return lut.view(torch.int16).to(torch.int64) & 0xFFFF


def int_dtype(k: int, n: int) -> torch.dtype:
    """The integer epilogue's dtype at K = ``k``: the accumulator's, int32
    up to :func:`int32_k_limit`, else int64."""
    return torch.int64 if wide_accumulator(k, (1 << (2 * n)) - 1) else torch.int32


def lut_matmul_plain(lut, mag_a, sign_a, mag_b, sign_b, *, n: int,
                     integer: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the same clamped gather and integer sums;
    ``integer`` returns the sums in :func:`int_dtype`."""
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
    return acc.to(int_dtype(k_dim, n) if integer else torch.float32)


def audit_body(lut, mag_a, sign_a, mag_b, sign_b, *, n: int, wide: bool,
               clamp: bool = True, integer: bool = False) -> torch.Tensor:
    """The kernel's arithmetic, carrier by carrier (``csrc/lut_matmul.cu``),
    for the certifier: int64 values, each marked with the word the kernel
    holds it in (``analysis.carrier``).  Bit-equal to
    :func:`lut_matmul_plain`.  The (k, row) word keeps the row's table
    byte offset ``2 |a| 2^n`` in bits 0-23, the (k, column) word the
    column's ``2 |b|`` in bits 0-15; their sum halved is the table index.
    Products sum per stage of :data:`STAGE_K` in int32, and over the K
    slice in int32 (``wide`` False) or into int64 (``wide``).
    ``clamp=False`` drops the magnitudes' clamp to 2^n - 1 (a mutation the
    tests hold the certifier to).  ``integer`` returns the accumulator
    itself, the integer epilogue's output, in place of its float32 value."""
    from repro_torch.analysis.carrier import carrier

    cu = "csrc/lut_matmul.cu"
    qmax = (1 << n) - 1
    ma, mb = mag_a.to(torch.int64), mag_b.to(torch.int64)
    if clamp:
        ma, mb = torch.clamp(ma, max=qmax), torch.clamp(mb, max=qmax)
    a_off = carrier((2 * ma) << n, 24, False, f"{cu}: (k, row) word, table-row byte offset")
    b_off = carrier(2 * mb, 16, False, f"{cu}: (k, column) word, column byte offset")
    idx = (a_off[:, :, None] + b_off[None, :, :]) >> 1  # (M, K, N) table entries
    prod = lut.to(torch.int64)[idx] * (sign_a.to(torch.int64)[:, :, None]
                                       * sign_b.to(torch.int64)[None, :, :])
    m_dim, k_dim, n_dim = prod.shape
    stages = -(-k_dim // STAGE_K)
    staged = prod
    if stages * STAGE_K > k_dim:  # the last stage's missing k add nothing
        staged = torch.cat([prod, prod.new_zeros((m_dim, stages * STAGE_K - k_dim, n_dim))], 1)
    carrier(staged.reshape(m_dim, stages, STAGE_K, n_dim).sum(dim=2), 32, True,
            f"{cu}: int32 part[][], one stage's products")
    # the stages' sum is the sum of the slice's K products (its envelope
    # counts K of them, not K rounded up to whole stages)
    acc = carrier(prod.sum(dim=1), 64 if wide else 32, True,
                  f"{cu}: acc[][] over the K slice ({'int64' if wide else 'int32'} by "
                  f"build.wide_accumulator)")
    return acc if integer else acc.to(torch.float32)


def int32_k_limit(n: int) -> int:
    """The largest K whose sums :func:`launch_plan` keeps in int32
    (``build.wide_accumulator`` on the table's bound 2^(2n) - 1)."""
    return ((1 << 31) - 1) // ((1 << (2 * n)) - 1)


def audit_trace(*, n: int, t: int = 0, m: int = 4, k: int | None = None, n_cols: int = 32,
                wide: bool | None = None, clamp: bool = True, integer: bool = False):
    """The certifier's contract of the kernel (nothing executes).

    The magnitudes range over their whole uint8 carrier, a miscalibrated
    quantizer, so what is proven is that the kernel's clamp keeps every
    lookup inside the 2^(2n)-entry table; the table holds
    ``[0, 2^(2n) - 1]`` in uint16 (the bound ``wide_accumulator`` takes).
    K defaults to the largest whose sums stay int32 (:func:`int32_k_limit`):
    the trace is of shapes only, so the proof covers the int32 choice at
    its edge.  ``t`` shapes only the table's contents; ``integer`` traces the
    integer epilogue (the accumulator is the output)."""
    from repro_torch.analysis.spec import TraceSpec, ValueRange, sds

    del t
    k = int32_k_limit(n) if k is None else k
    wide = wide_accumulator(k, (1 << (2 * n)) - 1) if wide is None else wide
    sgn = ValueRange.sign()
    return TraceSpec(
        name=f"kernel:lut_matmul[n={n},K={k}{',wide' if wide else ''}{',int' if integer else ''}]",
        fn=lambda lut, ma, sa, mb, sb: audit_body(lut, ma, sa, mb, sb, n=n, wide=wide,
                                                  clamp=clamp, integer=integer),
        args=[sds((1 << (2 * n),), torch.uint16), sds((m, k), torch.uint8),
              sds((m, k), torch.int8), sds((k, n_cols), torch.uint8),
              sds((k, n_cols), torch.int8)],
        ranges=[ValueRange(0.0, float((1 << (2 * n)) - 1), int_valued=True), None, sgn, None,
                sgn],
        facts={"k": k, "wide": wide},
    )


def lut_matmul(lut, mag_a, sign_a, mag_b, sign_b, *, n: int = 8,
               integer: bool = False) -> torch.Tensor:
    """(M, K) x (K, N) -> (M, N) float32 approximate GEMM, or with
    ``integer`` its exact sums in :func:`int_dtype` (the integer epilogue).

    lut: (2^(2n),) uint16 product table (``engine.artifacts.product_lut_u16``);
    mag_*: uint8 magnitudes; sign_*: int8 in {-1, 0, 1}; n <= 8.
    """
    if not 1 <= n <= 8:
        raise ValueError(f"lut_matmul supports 1 <= n <= 8, got n={n}")
    if mag_a.device.type == "cpu":
        return lut_matmul_plain(lut, mag_a, sign_a, mag_b, sign_b, n=n, integer=integer)
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
    audit_gate(KERNEL.name, "lut_gemm_int" if integer else "lut_gemm", n, max(1, n // 2))
    index = device_index(dev)
    plan, sms = _plan_on(index, m_dim, k_dim, n_dim, n)
    dtype = (torch.int64 if plan.wide else torch.int32) if integer else torch.float32
    out = torch.empty((m_dim, n_dim), dtype=dtype, device=dev)
    ws_ptr = counters = None
    if plan.splits > 1:
        ws = torch.empty(plan.workspace, dtype=torch.uint8, device=dev)
        ws_ptr = ws.data_ptr()
        counters = tile_counters(dev, plan.items // plan.splits).data_ptr()
    vec = (k_dim % 16 == 0 and n_dim % 16 == 0
           and all(x.data_ptr() % 16 == 0 for x in (mag_a, sign_a, mag_b, sign_b)))
    KERNEL.launch(
        dev, lut.data_ptr(), mag_a.data_ptr(), sign_a.data_ptr(), mag_b.data_ptr(),
        sign_b.data_ptr(), out.data_ptr(), m_dim, n_dim, k_dim, n, plan.bm, int(plan.wide),
        plan.splits, plan.k_chunk, sms, int(vec), ws_ptr, counters, int(integer),
    )
    return out
