"""Integer GEMM on two int16 K-lanes per 32-bit word (``inject`` body).

Counterpart of ``repro/kernels/packed_matmul.py``.  :func:`pack_i16_pairs`
packs consecutive K values into words (low half = even index, high half =
odd index), padding an odd K with a zero lane.  Words are int32 tensors
holding the reference's uint32 bit patterns (torch has no uint32
arithmetic on the CPU).  :func:`packed_matmul` runs the CUDA kernel
``csrc/packed_matmul.cu`` for CUDA tensors and the plain version
:func:`packed_matmul_plain` for CPU tensors.  The kernel splits each lane
into int8 planes for the int8 tensor cores and splits K over blocks at
small M (:func:`launch_plan`).  With ``integer=True`` the kernel and the
plain version return the exact sums, int32 (int64 past
:func:`int32_k_limit`), in place of their float32 conversion: the integer
epilogue of a tensor-parallel K shard (``engine/modes.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.build import (
    CudaKernel, audit_gate, check_operand, pick_tile, sm_count, split_k, tile_counters,
    wide_accumulator, workspace_bytes,
)

__all__ = [
    "KERNEL", "THREADS", "TILES", "Plan", "audit_body", "audit_pack", "audit_trace",
    "built_launch_plan", "int32_k_limit", "int_dtype", "launch_plan", "pack_i16_pairs", "packed_matmul",
    "packed_matmul_plain", "smem_bytes", "tile",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "packed_matmul", "packed_matmul_launch",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
)

# csrc/packed_matmul.cu: (tokens, weight columns) per block, four warps of
# 32 columns by 8, 16 or 32 tokens; words (64 K lanes) per stage
TILES = ((8, 128), (32, 64), (64, 64))
THREADS = 128
KW_STEP = 32
STAGES = 3  # cp.async ring depth
X_ROW = KW_STEP + 4  # words per token row of a stage (padded)
MIN_KW_CHUNK = 64  # the shortest slice of words a split gives a block


class Plan(NamedTuple):
    """One launch: the (bm, bn) block tile and the K words cut into
    ``splits`` slices of ``kw_chunk``."""

    bm: int
    bn: int
    splits: int
    kw_chunk: int


def tile(m: int) -> tuple[int, int]:
    """The kernel's (tokens, weight columns) block tile for ``m`` rows."""
    return pick_tile(m, TILES)


def smem_bytes(bm: int) -> int:
    """Dynamic shared memory of one block at token tile ``bm``: the ring of
    :data:`STAGES` stages of the weight's (KW_STEP, bn + 8) and the tokens'
    (bm, X_ROW) words (``Tile::kSmem``)."""
    bn = dict(TILES)[bm]
    return STAGES * (KW_STEP * (bn + 8) + bm * X_ROW) * 4


@functools.lru_cache(maxsize=4096)
def launch_plan(m: int, kw: int, n_cols: int, sms: int = 132) -> Plan:
    """The kernel's tile and split for an (m, kw) x (kw, n_cols) call in
    words on a card with ``sms`` SMs.  A slice may be any length: the
    kernel's int8 plane sums cover one step of 32 lanes (below 2^21) and
    fold into the block's sum, int64 where :func:`wide_accumulator` says so."""
    bm, bn = tile(m)
    tiles = -(-m // bm) * -(-n_cols // bn)
    splits, chunk = split_k(tiles, kw, step=KW_STEP, min_chunk=MIN_KW_CHUNK, sms=sms)
    return Plan(bm, bn, splits, chunk)


def built_launch_plan(plan: Plan, m: int, kw: int, n_cols: int) -> tuple:
    """(grid, threads, shared memory) of the launch that the built
    ``csrc/packed_matmul.cu`` makes for ``plan`` (its
    ``packed_matmul_plan``), which ``plan`` must match (grid ``(tiles_n,
    tiles_m, splits)``, :data:`THREADS`, :func:`smem_bytes`); builds the
    library, so it needs ``nvcc``."""
    fn = KERNEL.library().packed_matmul_plan
    fn.argtypes = [_I] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    err = fn(m, n_cols, kw, plan.bm, plan.splits, plan.kw_chunk, out)
    if err != 0:
        raise ValueError(f"packed_matmul_plan refused {plan} at {(m, kw, n_cols)}: "
                         f"CUDA error {err}")
    return tuple(out[:3]), out[3], out[4]


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


def int_dtype(kw: int, n: int) -> torch.dtype:
    """The integer epilogue's dtype for ``kw`` words (2 kw lanes) of n-bit
    lanes: the accumulator's, int32 up to :func:`int32_k_limit`, else int64."""
    return torch.int64 if wide_accumulator(2 * kw, ((1 << n) - 1) ** 2) else torch.int32


def packed_matmul_plain(pa: torch.Tensor, pb: torch.Tensor, *, n: int = 15,
                        integer: bool = False) -> torch.Tensor:
    """Plain PyTorch version.  The lane products and sums are integers
    below 2^53, so float64 products compute them exactly (CUDA has no
    integer matmul); the exact sum is converted to float32 once, or with
    ``integer`` to :func:`int_dtype`."""
    a_even, a_odd = _lanes(pa)
    b_even, b_odd = _lanes(pb)
    f64 = torch.float64
    acc = a_even.to(f64) @ b_even.to(f64) + a_odd.to(f64) @ b_odd.to(f64)
    return acc.to(int_dtype(pa.shape[1], n) if integer else torch.float32)


def audit_pack(q: torch.Tensor, *, dim: int) -> torch.Tensor:
    """:func:`pack_i16_pairs` for the certifier: the lanes themselves (an
    odd K padded with a zero lane), each marked as the int16 half of a
    word it is packed into, and left unpacked, so the interval of each
    lane is not lost in the bit surgery of packing."""
    from repro_torch.analysis.carrier import carrier

    q = q.to(torch.int64).movedim(dim, -1)
    if q.shape[-1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    q = carrier(q, 16, True, "csrc/packed_matmul.cu: an int16 lane of an int32 word")
    return q.movedim(-1, dim)


def audit_body(lanes_a: torch.Tensor, lanes_b: torch.Tensor, *, n: int,
               wide: bool, integer: bool = False) -> torch.Tensor:
    """The kernel's arithmetic on (M, K) x (K, N) lanes, carrier by carrier
    (``csrc/packed_matmul.cu``), for the certifier: each lane q = 256 h + l
    as a u8 low and an s8 high plane; per K step of 32 lanes the four
    plane products summed in int32 (the MMA accumulators), folded modulo
    the carrier into the block's sum, which must hold in int32 (``wide``
    False) or int64, which ``integer`` returns as the output in place of
    its float32 value.  Bit-equal to :func:`packed_matmul_plain` on the
    packed lanes."""
    from repro_torch.analysis.carrier import carrier

    cu = "csrc/packed_matmul.cu"
    a, b = lanes_a.to(torch.int64), lanes_b.to(torch.int64)
    la = carrier(a & 255, 8, False, f"{cu}: u8 low plane l = q & 255")
    ha = carrier(a >> 8, 8, True, f"{cu}: s8 high plane h = q >> 8")
    lb = carrier(b & 255, 8, False, f"{cu}: u8 low plane l = q & 255")
    hb = carrier(b >> 8, 8, True, f"{cu}: s8 high plane h = q >> 8")
    m_dim, k_dim = a.shape
    n_dim = b.shape[1]
    steps = -(-k_dim // 32)
    pad = steps * 32 - k_dim

    def step_sums(x, y, what):
        prod = x[:, :, None] * y[None, :, :]
        if pad:
            prod = torch.cat([prod, prod.new_zeros((m_dim, pad, n_dim))], 1)
        return carrier(prod.reshape(m_dim, steps, 32, n_dim).sum(dim=2), 32, True,
                       f"{cu}: s32 MMA accumulator of {what} over one K step")

    for x, y, what in ((ha, hb, "hh"), (ha, lb, "hl"), (la, hb, "lh"), (la, lb, "ll")):
        step_sums(x, y, what)
    # the four plane sums fold into one sum modulo the carrier, exact where
    # the total fits: 65536 hh + 256 (hl + lh) + ll = a b, lane by lane
    total = (a[:, :, None] * b[None, :, :]).sum(dim=1)
    total = carrier(total, 64 if wide else 32, True,
                    f"{cu}: the block's sum ({'int64' if wide else 'int32'} by "
                    f"build.wide_accumulator)")
    return total if integer else total.to(torch.float32)


def int32_k_limit(n: int) -> int:
    """The largest K (lanes) whose sums the kernel keeps in int32."""
    return ((1 << 31) - 1) // ((1 << n) - 1) ** 2


def audit_trace(*, n: int, t: int = 0, m: int = 8, k: int | None = None, n_cols: int = 32,
                wide: bool | None = None, integer: bool = False):
    """The certifier's contract of the kernel (nothing executes), past the
    wrapper's ``n <= 15`` guard: signed lanes ``|q| <= 2^n - 1`` packed two
    to a word (:func:`audit_pack`), K the largest whose sums stay int32."""
    from repro_torch.analysis.spec import TraceSpec, ValueRange, sds

    del t
    k = max(2, int32_k_limit(n) // 2 * 2) if k is None else k
    wide = wide_accumulator(k, ((1 << n) - 1) ** 2) if wide is None else wide
    q = ValueRange(-float((1 << n) - 1), float((1 << n) - 1), int_valued=True)
    return TraceSpec(
        name=f"kernel:packed_matmul[n={n},K={k}{',wide' if wide else ''}"
             f"{',int' if integer else ''}]",
        fn=lambda qa, qb: audit_body(audit_pack(qa, dim=1), audit_pack(qb, dim=0), n=n,
                                     wide=wide, integer=integer),
        args=[sds((m, k), torch.int64), sds((k, n_cols), torch.int64)],
        ranges=[q, q],
        facts={"k": k, "wide": wide},
    )


def packed_matmul(pa: torch.Tensor, pb: torch.Tensor, *, n: int = 15,
                  integer: bool = False) -> torch.Tensor:
    """Packed (M, K/2) x (K/2, N) -> (M, N) float32 integer GEMM, or with
    ``integer`` its exact sums in :func:`int_dtype` (the integer epilogue).

    Operands come from :func:`pack_i16_pairs` (``dim=1`` for the left,
    ``dim=0`` for the right).  ``n`` bounds the lane magnitudes
    (|q| <= 2^n - 1, n <= 15) and picks the kernel's accumulator width.
    """
    if not 1 <= n <= 15:
        raise ValueError(f"packed_matmul lanes hold n <= 15 bit magnitudes, got n={n}")
    if pa.device.type == "cpu":
        return packed_matmul_plain(pa, pb, n=n, integer=integer)
    dev = pa.device
    m_dim, kw = pa.shape
    n_dim = pb.shape[1]
    check_operand(pa, "pa", torch.int32, (m_dim, kw), dev)
    check_operand(pb, "pb", torch.int32, (kw, n_dim), dev)
    audit_gate(KERNEL.name, "packed_gemm_int" if integer else "packed_gemm", n, max(1, n // 2))
    plan = launch_plan(m_dim, kw, n_dim, sm_count(dev))
    wide = wide_accumulator(2 * kw, ((1 << n) - 1) ** 2)
    dtype = (torch.int64 if wide else torch.int32) if integer else torch.float32
    out = torch.empty((m_dim, n_dim), dtype=dtype, device=dev)
    ws = ws_ptr = counters = None
    if plan.splits > 1:
        dtype = torch.int64 if wide else torch.int32
        nbytes = workspace_bytes(plan.splits, m_dim, n_dim, wide)
        ws = torch.empty(nbytes // dtype.itemsize, dtype=dtype, device=dev)
        ws_ptr = ws.data_ptr()
        counters = tile_counters(dev, -(-m_dim // plan.bm) * -(-n_dim // plan.bn)).data_ptr()
    vec = kw % 4 == 0 and n_dim % 4 == 0 and pa.data_ptr() % 16 == 0 and pb.data_ptr() % 16 == 0
    KERNEL.launch(
        dev, pa.data_ptr(), pb.data_ptr(), out.data_ptr(), ws_ptr, counters, m_dim, n_dim, kw,
        plan.bm, plan.splits, plan.kw_chunk, int(vec), int(wide), int(integer),
    )
    return out
