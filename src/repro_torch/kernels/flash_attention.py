"""Flash attention (forward and backward) and flash decode, with GQA by head index.

Counterpart of ``repro/kernels/flash_attention.py``.  :func:`flash_attention`
and :func:`flash_decode` run the CUDA kernels of ``csrc/flash_attention.cu``
for CUDA tensors and the plain versions for CPU tensors; there is no
other fallback.  :func:`flash_attention` is differentiable: as the
reference's ``custom_vjp``, its forward also writes lse = m + log(l) and
its backward (:func:`flash_attention_bwd`) runs the FlashAttention-2
recompute, the dq and dk/dv kernels of ``csrc/flash_attention_bwd.cu`` on
the card and :func:`flash_attention_bwd_plain` on the CPU.  Layouts are
the reference's: q (B, S, H, hd), k/v (B, T, KV, hd) unrepeated,
positions (B, S) / (B, T) with ``-1`` marking an unwritten cache slot;
decode takes q (B, H, hd) and q_pos (B,).  Outputs are float32.  The
reference's ``bq``/``bk``/``interpret`` arguments have no counterpart: the
tiles are the kernel's own, and they change only the order of float32
sums.  Every kernel runs its products on the bf16 tensor cores (the
decode, bytes-bound, on float32 FMAs), a float32 operand split into bf16
terms, and skips the tiles that add nothing: :func:`launch_plan` and
:func:`smem_bytes` give the launches (``"fwd"``, ``"decode"``, ``"dq"``,
``"dkv"``), :func:`fwd_tile_plan` the (query tile, key tile) pairs the
forward computes, :func:`decode_chunk_plan` the cache chunks the decode
reads, :func:`bwd_tile_plan` the backward's tiles, for tests on the CPU.
:func:`launch_forward` and :func:`launch_decode` are the two kernels'
launches with an optional on-card count of the pairs or chunks skipped.

The plain versions are the port's attention math, also used by
``models/attention.py`` on its plain path: the direct softmax, or the
blockwise online softmax for long sequences, with query head h reading KV
head h // g.  ``NEG_INF`` is the reference's finite large negative, never
-inf (see ``csrc/flash_attention.cu`` for why that matters).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import (
    SMEM_PER_BLOCK, CudaKernel, audit_gate, check_operand, float_scratch, sm_count, tile_counters,
)

__all__ = [
    "DECODE_KERNEL", "DKV_KERNEL", "DQ_KERNEL", "FORWARD_KERNEL", "BwdPlan", "FlashBackward",
    "FwdPlan", "NEG_INF", "allow_mask", "attend", "built_launch_plan", "bwd_probs",
    "bwd_tile_plan", "combine_ranges", "decode_chunk_plan", "decode_split", "flash_attention",
    "flash_attention_bwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
    "flash_attention_bwd_plain", "flash_attention_fwd", "flash_attention_plain", "flash_decode",
    "flash_decode_plain", "fwd_tile_plan", "launch_decode", "launch_forward", "launch_plan",
    "needs_grad", "smem_bytes",
]

NEG_INF = -2.3819763e38  # bf16-safe large negative (the reference's value)
Q_CHUNK = 1024
K_CHUNK = 1024
HEAD_DIMS = (16, 32, 64, 128, 256)  # the head widths every attention kernel is built for
MAX_GROUP = 16  # flash_decode: query heads per KV head

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# (q, k, v, q_pos, k_pos, out, lse, skipped, dtype, B, S, T, H, KV, hd, causal, window,
#  softcap, scale, sms, device, stream)
FORWARD_KERNEL = CudaKernel(
    "flash_attention", "flash_attention_launch",
    [_P] * 8 + [_I] * 9 + [_F, _F, _I, _I, _P],
)
# (q, k, v, q_pos, k_pos, out, lse, workspace, its floats, counters, skipped, dtype, B, T, H,
#  KV, hd, window, softcap, scale, sms, device, stream)
DECODE_KERNEL = CudaKernel(
    "flash_decode", "flash_decode_launch",
    [_P] * 8 + [_LL, _P, _P] + [_I] * 7 + [_F, _F, _I, _I, _P],
    source="flash_attention",
)
# (q, k, v, do, lse, dd, q_pos, k_pos, outputs..., dtype, B, S, T, H, KV, hd, causal,
#  window, softcap, scale, device, stream)
DQ_KERNEL = CudaKernel(
    "flash_attention_bwd_dq", "flash_attention_bwd_dq_launch",
    [_P] * 9 + [_I] * 9 + [_F, _F, _I, _P], source="flash_attention_bwd",
)
DKV_KERNEL = CudaKernel(
    "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_launch",
    [_P] * 10 + [_I] * 9 + [_F, _F, _I, _P], source="flash_attention_bwd",
)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# csrc/flash_attention_bwd.cu: dq blocks of 64 query rows (four warps of 16)
# stepping over 32 key slots; dk/dv blocks of 64 slots stepping over 32
# query rows, in two warp groups of four warps for bf16 inputs (one for
# float32); a float32 operand enters the bf16 tensor cores as SPLIT terms,
# a bf16 one as it is; cp.async rings of STAGES steps; bf16 rows padded by
# 8.  Past head width 128 dk/dv takes one group of eight warps, two to each
# 16 slots (each half of dk's and dv's columns), and float32 operands are
# split straight from device memory into one step's planes, in both
# kernels, with no ring
DQ_ROWS, DQ_KEYS, KV_KEYS, KV_ROWS = 64, 32, 64, 32
GROUP_THREADS, SPLIT, STAGES, ROW_PAD = 128, 2, 2, 8
# csrc/flash_attention.cu: forward items of 64 row-heads (four warps of
# 16: the group's query heads over its query rows) walking key tiles of
# 64, two items to a bf16 block (a long one and a short one) where that
# makes one wave, bf16 k and v through a two-stage cp.async ring, float32
# q, k, v as FWD_SPLIT bf16 terms read tile by tile; at head widths over
# 128, two warps to each 16 row-heads (each half the output columns), one
# item a block, and float32 key tiles of 32; decode blocks of 128 threads per
# (KV head, cache chunk, batch), tiles of 32 slots in a two-stage ring,
# chunks of whole DEC_STEP slots, about DEC_PER_SM blocks per SM, at most
# DEC_MAX_CHUNKS of them
FWD_ROW_HEADS, FWD_KEYS, FWD_THREADS, FWD_STAGES, FWD_SPLIT = 64, 64, 128, 2, 3
DEC_TILE, DEC_STAGES, DEC_THREADS, DEC_STEP, DEC_PER_SM, DEC_MAX_CHUNKS = 32, 2, 128, 16, 4, 32


class BwdPlan(NamedTuple):
    """One launch of a backward kernel: its grid, threads per block and
    dynamic shared memory in bytes."""

    grid: tuple
    threads: int
    smem: int


class FwdPlan(NamedTuple):
    """One launch of the forward or the decode: grid, threads per block,
    dynamic shared memory in bytes; the forward's query rows and query
    heads per item and key slots per tile, or the decode's 1 row, the
    group's query heads and the slots per cache chunk."""

    grid: tuple
    threads: int
    smem: int
    rows: int
    heads: int
    keys: int


def _planes(dtype: torch.dtype) -> int:
    """bf16 terms per value of q, k, v: 1 for bf16, SPLIT for float32."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype}; the kernels take {list(_DTYPES)}")
    return 1 if dtype == torch.bfloat16 else SPLIT


def _fwd_groups(dtype: torch.dtype, hd: int, items: int = 0, sms: int = 1) -> int:
    """Items side by side in one forward block (a group of four warps
    each): two where bf16 at a head width up to 128 allows it and the items
    are more than one per SM but fit two per SM (one wave, a long and a
    short item on each SM), else one (``fwd_groups`` of
    ``csrc/flash_attention.cu``); ``items = 0``: the most there may be."""
    most = 2 if _planes(dtype) == 1 and hd <= 128 else 1
    return most if items == 0 or sms < items <= 2 * sms else 1


def _halves(hd: int) -> int:
    """Warps that share each 16 row-heads of the forward, or each 16 slots
    of dk/dv, each taking ``hd / halves`` output columns: two past head
    width 128 (``kHalves`` of both)."""
    return 2 if hd > 128 else 1


def _fwd_keys(dtype: torch.dtype, hd: int) -> int:
    """Key slots per forward tile: 64, or 32 for float32 past head width
    128, whose three planes of 64-slot tiles overflow the shared memory
    (``kKeys``)."""
    return FWD_KEYS // 2 if _planes(dtype) > 1 and hd > 128 else FWD_KEYS


def _groups(dtype: torch.dtype, hd: int) -> int:
    """Warp groups of the dk/dv kernel: two for bf16 up to head width 128,
    else one."""
    return 2 if _planes(dtype) == 1 and hd <= 128 else 1


def _direct(dtype: torch.dtype, hd: int) -> bool:
    """Whether the backward splits its streamed float32 operands straight
    from device memory into one step's planes (``kDirect``): past head
    width 128, where a two-stage ring of them overflows the shared memory."""
    return _planes(dtype) > 1 and hd > 128


def smem_bytes(kernel: str, hd: int, dtype: torch.dtype, s: int, t: int, group: int,
               items: int = 0, sms: int = 1) -> int:
    """Dynamic shared memory of one block of ``kernel`` ("fwd", "decode",
    "dq" or "dkv") at head width ``hd``, S = ``s`` query rows, T = ``t``
    slots and ``group`` query heads per KV head (the forward's: at its most
    groups, or for ``items`` work items on ``sms`` SMs); kept in step with
    the layouts of ``csrc/flash_attention.cu`` (``FwdLayout``,
    ``DecLayout``) and ``csrc/flash_attention_bwd.cu`` (``DqLayout``,
    ``KvLayout``)."""
    row = 2 * (hd + ROW_PAD)
    if kernel == "fwd":
        planes = 1 if _planes(dtype) == 1 else FWD_SPLIT
        keys = _fwd_keys(dtype, hd)
        stage = 2 * planes * keys * row + keys * 4  # k, v planes; slot positions
        stages = FWD_STAGES if planes == 1 else 1
        mask = 16 * -(-t // (keys * 128))  # live-tile bits in whole 16-byte units
        return _fwd_groups(dtype, hd, items, sms) * (planes * FWD_ROW_HEADS * row
                                                     + stages * stage + mask)
    if kernel == "decode":
        size = 2 if _planes(dtype) == 1 else 4
        tile = DEC_TILE * (hd * size + 16)  # rows padded by 16 bytes
        # q (whole 16 bytes), the ring (k, v, slot positions), the scores and
        # three stats per row, for the group's rows
        return (-(-group * hd * 4 // 16) * 16 + DEC_STAGES * (2 * tile + DEC_TILE * 4)
                + group * (DEC_TILE + 3) * 4)
    planes = _planes(dtype)
    raw, direct = planes > 1, _direct(dtype, hd)
    if kernel == "dq":
        kv_planes = 2 * planes * DQ_KEYS * row
        stage = (2 * DQ_KEYS * hd * 4 if raw else kv_planes) + DQ_KEYS * 4
        # the ring, or (direct) one step's planes and slot positions
        streamed = kv_planes + DQ_KEYS * 4 if direct else \
            STAGES * stage + (kv_planes if raw else 0)
        fixed = (planes + SPLIT) * DQ_ROWS * row + streamed
        entries = -(-t // DQ_KEYS)
    elif kernel == "dkv":
        q_stage = KV_ROWS * hd * 4 if raw else KV_ROWS * row
        stage = q_stage + KV_ROWS * hd * 4 + 3 * KV_ROWS * 4
        planes_q = (SPLIT + (planes if raw else 0)) * KV_ROWS * row  # split do (and q)
        area = planes_q + (3 * KV_ROWS * 4 if direct else STAGES * stage)
        fixed = 2 * planes * KV_KEYS * row + _groups(dtype, hd) * area
        entries = group * -(-s // KV_ROWS)
    else:
        raise ValueError(f"kernel must be 'fwd', 'decode', 'dq' or 'dkv', got {kernel!r}")
    return fixed + 4 * -(-entries // 32)  # the live-tile bit mask


def _fwd_geometry(h: int, kv: int) -> tuple[int, int, int]:
    """``(rows, heads, chunks)`` of the forward's work items: ``heads`` query
    heads of a KV head's group (all g, or chunks of 64) over ``rows`` query
    rows, 64 row-heads in all (``fwd_geometry`` of
    ``csrc/flash_attention.cu``)."""
    g = h // kv
    heads = min(g, FWD_ROW_HEADS)
    return FWD_ROW_HEADS // heads, heads, -(-g // heads)


def decode_split(b: int, t: int, kv: int, sms: int) -> tuple[int, int]:
    """``(chunks, chunk)``: the decode's cut of T slots into chunks of
    ``chunk`` (a multiple of 16; the last may be shorter, none is empty),
    as many as give about four blocks per SM over the b x kv pairs, at
    most 32.  The kernel decides its split itself (``decode_split`` of
    ``csrc/flash_attention.cu``); this copy is :func:`launch_plan`'s, for
    the tests on the CPU."""
    want = min(DEC_MAX_CHUNKS, max(1, DEC_PER_SM * sms // (b * kv)))
    n = min(want, -(-t // DEC_STEP))
    chunk = -(-(-(-t // n)) // DEC_STEP) * DEC_STEP
    return -(-t // chunk), chunk


def launch_plan(kernel: str, b: int, s: int, t: int, h: int, kv: int, hd: int,
                dtype: torch.dtype, sms: Optional[int] = None):
    """One launch of ``kernel`` on q (b, s, h, hd) and k/v (b, t, kv, hd):
    a :class:`BwdPlan` for "dq" and "dkv", a :class:`FwdPlan` for "fwd"
    (one block per one or two work items, a group of four warps each) and
    "decode" (one block per KV head, cache chunk and batch row), both on a
    card with ``sms`` SMs."""
    _check_width(hd)
    if kernel in ("fwd", "decode") and sms is None:
        raise ValueError(f"the {kernel} plan needs the card's SM count (sms=)")
    if kernel == "fwd":
        rows, heads, chunks = _fwd_geometry(h, kv)
        items = b * kv * chunks * -(-s // rows)
        groups = _fwd_groups(dtype, hd, items, sms)
        smem = smem_bytes(kernel, hd, dtype, s, t, h // kv, items, sms)
        return FwdPlan((-(-items // groups), 1, 1), groups * FWD_THREADS * _halves(hd),
                       smem, rows, heads, _fwd_keys(dtype, hd))
    smem = smem_bytes(kernel, hd, dtype, s, t, h // kv)
    if kernel == "decode":
        if h // kv > MAX_GROUP:
            raise ValueError(f"flash_decode takes up to {MAX_GROUP} query heads per KV head")
        chunks, chunk = decode_split(b, t, kv, sms)
        return FwdPlan((kv, chunks, b), DEC_THREADS, smem, 1, h // kv, chunk)
    if kernel == "dq":
        return BwdPlan((-(-s // DQ_ROWS), h, b), DQ_ROWS // 16 * 32, smem)  # a warp per 16 rows
    return BwdPlan((-(-t // KV_KEYS), kv, b), _groups(dtype, hd) * GROUP_THREADS * _halves(hd),
                   smem)


def built_launch_plan(kernel: str, b: int, s: int, t: int, h: int, kv: int, hd: int,
                      dtype: torch.dtype, sms: Optional[int] = None):
    """The launch that the built library makes for these arguments (the
    ``flash_attention_plan`` of ``csrc/flash_attention.cu`` for "fwd" and
    "decode", the ``flash_attention_bwd_plan`` of
    ``csrc/flash_attention_bwd.cu`` for "dq" and "dkv"), which
    :func:`launch_plan` must equal; builds the library, so it needs
    ``nvcc``."""
    if kernel in ("fwd", "decode"):
        fn = FORWARD_KERNEL.library().flash_attention_plan
        fn.argtypes = [_I] * 9 + [ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
        out = (ctypes.c_longlong * 8)()
        err = fn(int(kernel == "decode"), _DTYPES[dtype], b, s, t, h, kv, hd, sms or 0, out)
        if err != 0:
            raise ValueError(f"flash_attention_plan refused {kernel} {(b, s, t, h, kv, hd)} "
                             f"{dtype}: CUDA error {err}")
        return FwdPlan(tuple(out[:3]), *out[3:])
    if kernel not in ("dq", "dkv"):
        raise ValueError(f"kernel must be 'fwd', 'decode', 'dq' or 'dkv', got {kernel!r}")
    fn = DQ_KERNEL.library().flash_attention_bwd_plan
    fn.argtypes = [_I] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    err = fn(int(kernel == "dkv"), _DTYPES[dtype], b, s, t, h, kv, hd, out)
    if err != 0:
        raise ValueError(f"flash_attention_bwd_plan refused {kernel} {(b, s, t, h, kv, hd)} "
                         f"{dtype}: CUDA error {err}")
    return BwdPlan(tuple(out[:3]), out[3], out[4])


# ------------------------------------------------------------ plain math
def allow_mask(q_pos, k_pos, *, causal: bool, window: Optional[int]):
    """(B, Sq, Sk) boolean allow-mask from position ids."""
    m = k_pos[:, None, :] >= 0  # -1 marks unwritten cache slots
    if causal:
        m = m & (q_pos[:, :, None] >= k_pos[:, None, :])
    if window is not None:
        m = m & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    return m


def _scores(q, k, softcap, scale):
    """q (B,S,H,hd), k (B,T,KV,hd) -> (B,H,S,T) float32; head h reads KV head h // g."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.to(torch.float32).reshape(b, s, kv, h // kv, hd)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32)).reshape(b, h, s, -1)
    sc = sc * scale
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
    return sc


def _weighted_values(probs, v):
    """probs (B,H,S,T), v (B,T,KV,hd) -> (B,H,S,hd)."""
    b, h, s, t = probs.shape
    kv = v.shape[2]
    pg = probs.reshape(b, kv, h // kv, s, t)
    return torch.einsum("bkgst,btkd->bkgsd", pg, v.to(torch.float32)).reshape(b, h, s, -1)


def _lse(logits):
    """The forward's residual m + log(max(l, 1e-30)) of masked logits, as the
    reference's forward writes it: a row with every slot masked has m =
    NEG_INF and l = T, so its lse is NEG_INF + log T = NEG_INF in float32."""
    m = logits.amax(dim=-1)
    l = torch.exp(logits - m[..., None]).sum(dim=-1)
    return m + torch.log(torch.clamp(l, min=1e-30))


def _attend_direct(q, k, v, q_pos, k_pos, *, causal, window, softcap, scale, with_lse=False):
    logits = _scores(q, k, softcap, scale)
    allow = allow_mask(q_pos, k_pos, causal=causal, window=window)
    logits = torch.where(allow[:, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = _weighted_values(probs, v).transpose(1, 2)  # (B, S, H, hd)
    return (out, _lse(logits)) if with_lse else out


def _attend_flash(q, k, v, q_pos, k_pos, *, causal, window, softcap, scale,
                  q_chunk=Q_CHUNK, k_chunk=K_CHUNK, with_lse=False):
    """Blockwise online softmax over (q_chunk, k_chunk) tiles.  Lengths that
    are not multiples of the chunks (the reference asserts that they are)
    end in a short tile: its missing query rows are zeros whose output is
    dropped, its missing key slots score -inf, so they add nothing to any
    row, not even to one with no allowed slot (its running max stays
    ``NEG_INF``, and it averages its T real slots)."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    q_chunk, k_chunk = min(q_chunk, s), min(k_chunk, t)
    s_pad, t_pad = -(-s // q_chunk) * q_chunk, -(-t // k_chunk) * k_chunk
    if s_pad > s:
        q = F.pad(q, (0, 0, 0, 0, 0, s_pad - s))
        q_pos = F.pad(q_pos, (0, s_pad - s), value=-1)
    if t_pad > t:
        k, v = (F.pad(x, (0, 0, 0, 0, 0, t_pad - t)) for x in (k, v))
        k_pos = F.pad(k_pos, (0, t_pad - t), value=-1)
    outs, lses = [], []
    for q0 in range(0, s_pad, q_chunk):
        qb, qpb = q[:, q0:q0 + q_chunk], q_pos[:, q0:q0 + q_chunk]
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, q_chunk, hd), dtype=torch.float32, device=q.device)
        for k0 in range(0, t_pad, k_chunk):
            kb, vb = k[:, k0:k0 + k_chunk], v[:, k0:k0 + k_chunk]
            logits = _scores(qb, kb, softcap, scale)
            allow = allow_mask(qpb, k_pos[:, k0:k0 + k_chunk], causal=causal, window=window)
            logits = torch.where(allow[:, None, :, :], logits, NEG_INF)
            if k0 + k_chunk > t:
                logits[..., t - k0:] = -torch.inf
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _weighted_values(p, vb)
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).transpose(1, 2))  # (B, qc, H, hd)
        lses.append(m + torch.log(l))
    out = torch.cat(outs, dim=1)[:, :s]
    return (out, torch.cat(lses, dim=-1)[..., :s]) if with_lse else out


def attend(q, k, v, q_pos, k_pos, *, causal, window, softcap, scale, decode=False,
           with_lse=False):
    """The plain attention: direct softmax, or blockwise past the chunk
    sizes (never at decode, as the reference's plain path).  With
    ``with_lse`` it returns ``(out, lse)``, lse (B, H, S) float32."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale, with_lse=with_lse)
    if not decode and (q.shape[1] > Q_CHUNK or k.shape[1] > 4 * K_CHUNK):
        return _attend_flash(q, k, v, q_pos, k_pos, **kw)
    return _attend_direct(q, k, v, q_pos, k_pos, **kw)


def flash_attention_plain(q, k, v, q_pos, k_pos, causal=True, window=None, softcap=None,
                          scale=1.0) -> torch.Tensor:
    return attend(q, k, v, q_pos, k_pos, causal=causal, window=window, softcap=softcap,
                  scale=scale)


def bwd_probs(q, k, v, q_pos, k_pos, lse, do, dd, causal=True, window=None, softcap=None,
              scale=1.0):
    """The backward's recomputed ``(p, ds)``, each (B, H, S, T) float32: p =
    exp(s - lse) with s = NEG_INF on masked slots (so p = 1 there on a row
    with no allowed slot, 0 on every other row), ds = p (dp - dd) (1 -
    tanh^2 under softcap), 0 on masked slots.  ``do`` is float32 and ``dd``
    = sum(do * o) (B, H, S)."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    raw = _scores(q, k, None, scale)  # (B, H, S, T)
    th = None
    if softcap:
        th = torch.tanh(raw / softcap)
        sc = th * softcap
    else:
        sc = raw
    allow = allow_mask(q_pos, k_pos, causal=causal, window=window)[:, None]
    p = torch.exp(torch.where(allow, sc, NEG_INF) - lse[..., None])
    dog = do.reshape(b, s, kv, h // kv, hd)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.to(torch.float32)).reshape(b, h, s, t)
    ds = p * (dp - dd[..., None])
    if th is not None:
        ds = ds * (1.0 - th * th)
    return p, torch.where(allow, ds, 0.0)


def flash_attention_bwd_plain(q, k, v, q_pos, k_pos, o, lse, do, causal=True, window=None,
                              softcap=None, scale=1.0):
    """The reference's ``_bwd`` in torch: the FlashAttention-2 recompute of
    probabilities from the forward's ``lse``, not autograd through a
    softmax.  Returns (dq (B,S,H,hd), dk, dv (B,T,KV,hd)) float32.

    It differs from autograd of :func:`attend` in one place, on purpose: a
    query row with no allowed slot has lse = NEG_INF, so p = exp(NEG_INF -
    NEG_INF) = 1 on every slot, and ``dv`` (not masked, as in the
    reference) takes that row's ``do`` at every slot with weight 1, not 1/T.
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    do = do.to(torch.float32)
    dd = torch.einsum("bshd,bshd->bhs", do, o.to(torch.float32))
    p, ds = bwd_probs(q, k, v, q_pos, k_pos, lse, do, dd, causal=causal, window=window,
                      softcap=softcap, scale=scale)
    dog = do.reshape(b, s, kv, g, hd)
    dv = torch.einsum("bkgst,bskgd->btkd", p.reshape(b, kv, g, s, t), dog)
    ds = ds.reshape(b, kv, g, s, t)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(torch.float32)).reshape(b, s, h, hd)
    qg = q.to(torch.float32).reshape(b, s, kv, g, hd)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg)
    return dq * scale, dk * scale, dv


def _tiles(x: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """(N, L) -> (N, ceil(L / rows), rows), the tail filled with ``fill``."""
    n, length = x.shape
    pad = torch.full((n, -length % rows), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1).reshape(n, -1, rows)


def bwd_tile_plan(q_pos, k_pos, lse, *, causal: bool, window: Optional[int]):
    """The tiles the backward kernels compute, by the rule they follow
    (``csrc/flash_attention_bwd.cu``), decided from positions and lse.

    Returns ``(dq_live, dkv_live)``: ``dq_live`` (B, ceil(S/64), ceil(T/32))
    for the dq kernel's blocks of 64 query rows and its steps of 32 slots
    (live when some written slot of the step may be allowed for the block's
    query positions, judged by their min and max); ``dkv_live`` (B, H,
    ceil(T/64), ceil(S/32)) for the dk/dv kernel's blocks of 64 slots and
    its steps of 32 rows of query head h (live when some row may attend a
    slot of the block, judged by the written slots' min and max, or when
    some row puts p != 0 on masked slots: a pad row, lse = NEG_INF).  A tile
    that is not live adds exactly 0: its ds is 0, and in dk/dv its p too.
    """
    b, h = lse.shape[:2]
    big = torch.iinfo(torch.int64).max // 4
    qp, kp = q_pos.to(torch.int64), k_pos.to(torch.int64)
    rows = torch.ones_like(qp, dtype=torch.bool)

    # dq: the block's query positions by their min and max
    exists = _tiles(rows, DQ_ROWS, False)
    qt = _tiles(qp, DQ_ROWS, 0)
    qmin = torch.where(exists, qt, big).amin(-1)[:, :, None, None]
    qmax = torch.where(exists, qt, -big).amax(-1)[:, :, None, None]
    slots = _tiles(kp, DQ_KEYS, -1)[:, None]  # (B, 1, nK, 32)
    may = slots >= 0
    if causal:
        may = may & (slots <= qmax)
    if window is not None:
        may = may & (qmin - slots < window)
    dq_live = may.any(-1)

    # dk/dv: the block's written slots by their min and max
    kb = _tiles(kp, KV_KEYS, -1)
    written = kb >= 0
    kmin = torch.where(written, kb, big).amin(-1)[:, :, None, None]
    kmax = torch.where(written, kb, -big).amax(-1)[:, :, None, None]
    qr = _tiles(qp, KV_ROWS, 0)[:, None]  # (B, 1, nQ, 32)
    may = written.any(-1)[:, :, None, None] & _tiles(rows, KV_ROWS, False)[:, None]
    if causal:
        may = may & (qr >= kmin)
    if window is not None:
        may = may & (qr - kmax < window)
    pad = torch.exp(NEG_INF - lse.to(torch.float32)) != 0  # (B, H, S)
    pad = _tiles(pad.reshape(b * h, -1), KV_ROWS, False).reshape(b, h, -1, KV_ROWS)
    dkv_live = may.any(-1)[:, None] | pad.any(-1)[:, :, None, :]
    return dq_live, dkv_live


def fwd_tile_plan(q_pos, k_pos, *, rows: int, keys: int, causal: bool,
                  window: Optional[int]) -> torch.Tensor:
    """The (query tile, key tile) pairs the forward kernels compute, by the
    masked-block rule they follow (``csrc/flash_attention.cu``; the
    approximate forward's through :func:`approx_tile_plan`), from
    positions alone.

    Returns ``live`` (B, ceil(S / rows), ceil(T / keys)) bool.  A pair is
    skipped (``False``) when (a) no row of the tile may attend any written
    slot of the key tile, judged from the tile's least and greatest
    position against each slot, and (b) every row of the tile has an
    allowed slot somewhere in T.  A skipped pair leaves every row's (m, l,
    acc) as they were; a tile with a row that has no allowed slot (a left
    pad) keeps every key tile.
    """
    b = q_pos.shape[0]
    big = torch.iinfo(torch.int64).max // 4
    qp, kp = q_pos.to(torch.int64), k_pos.to(torch.int64)
    exists = _tiles(torch.ones_like(qp, dtype=torch.bool), rows, False)
    qt = _tiles(qp, rows, 0)
    qmin = torch.where(exists, qt, big).amin(-1)[:, :, None, None]
    qmax = torch.where(exists, qt, -big).amax(-1)[:, :, None, None]
    slots = _tiles(kp, keys, -1)[:, None]  # (B, 1, nK, keys)
    may = slots >= 0
    if causal:
        may = may & (slots <= qmax)
    if window is not None:
        may = may & (qmin - slots < window)
    has = allow_mask(q_pos, k_pos, causal=causal, window=window).any(-1).expand(qp.shape)
    missing = _tiles(~has, rows, False).any(-1)  # (B, nQ): a row with no allowed slot
    return may.any(-1) | missing[:, :, None].expand(b, -1, may.shape[2])


def decode_chunk_plan(q_pos, k_pos, *, chunk: int, window: Optional[int]) -> torch.Tensor:
    """The cache chunks of ``chunk`` slots the decode kernel reads: ``live``
    (B, ceil(T / chunk)) bool, a chunk being live when some slot of it is
    allowed for the row's position q_pos (B,) (causal, and the window).
    The group's query heads share that position, so a chunk that is not
    live adds nothing to any of them, and the kernel skips it for every KV
    head; a row with no live chunk gets the uniform average of all T slots.
    """
    allow = allow_mask(q_pos[:, None], k_pos, causal=True, window=window)[:, 0]  # (B, T)
    return _tiles(allow, chunk, False).any(-1)


def flash_decode_plain(q, k, v, q_pos, k_pos, *, window=None, softcap=None,
                       scale=1.0, with_lse=False):
    """The plain decode: (B, H, hd), and with ``with_lse`` also lse (B, H)."""
    got = attend(q[:, None], k, v, q_pos[:, None], k_pos, causal=True, window=window,
                 softcap=softcap, scale=scale, decode=True, with_lse=with_lse)
    if with_lse:
        return got[0][:, 0], got[1][..., 0]
    return got[:, 0]


def combine_ranges(outs, lses):
    """Attention over slot ranges combined into attention over their union:
    ``outs`` (R, ..., H?, hd) and ``lses`` of the matching shape without hd,
    one per range in range order; returns ``(o, lse)``.  The ranges are
    added in order 0, 1, 2, ... with weights exp(lse_r - M), M the largest
    lse, so every rank of a group that combines the same parts gets the
    same bits.  A row with no allowed slot in any range has lse = NEG_INF
    everywhere, weight 1 in each, and so the average of the ranges' uniform
    averages: over ranges of equal length, the uniform average of every
    slot, the whole decode's result there; a range with none while another
    has one weighs exp(NEG_INF - lse) = 0."""
    m = lses[0]
    for r in range(1, lses.shape[0]):
        m = torch.maximum(m, lses[r])
    num = den = None
    for r in range(lses.shape[0]):
        w = torch.exp(lses[r] - m)
        part = outs[r] * w[..., None]
        num = part if num is None else num + part
        den = w if den is None else den + w
    return num / den[..., None], m + torch.log(den)


# -------------------------------------------------------------- wrappers
def _check_width(hd: int) -> None:
    """Raise unless the attention kernels are built for head width ``hd``."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of the built widths {HEAD_DIMS}")


def _check_qkv(q, k, v, q_pos, k_pos, q_shape, k_shape, qp_shape):
    dev = q.device
    dtype = q.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"q has dtype {dtype}; the kernels take {list(_DTYPES)}")
    _check_width(q_shape[-1])
    check_operand(q, "q", dtype, q_shape, dev)
    check_operand(k, "k", dtype, k_shape, dev)
    check_operand(v, "v", dtype, k_shape, dev)
    check_operand(q_pos, "q_pos", torch.int32, qp_shape, dev)
    check_operand(k_pos, "k_pos", torch.int32, k_shape[:2], dev)
    h, kv = (q_shape[1] if len(q_shape) == 3 else q_shape[2]), k_shape[2]
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not split into groups over {kv} KV heads")
    return _DTYPES[dtype]


def _i32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int32 and x.is_contiguous():
        return x  # the common case, without a call into the dispatcher
    return x.to(torch.int32).contiguous()


def _window(window) -> int:
    return -1 if window is None else int(window)


def needs_grad(*tensors) -> bool:
    """Whether autograd will ask these inputs for a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _aligned(*tensors):
    """The tensors, each cloned where its data is not 16-byte aligned (the
    kernels copy rows 16 bytes at a time)."""
    return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in tensors)


def _skipped_ptr(skipped: Optional[torch.Tensor], device: torch.device):
    if skipped is None:
        return None
    check_operand(skipped, "skipped", torch.int32, (1,), device)
    return skipped.data_ptr()


def launch_forward(q, k, v, q_pos, k_pos, *, causal=True, window=None, softcap=None, scale=1.0,
                   with_lse=False, skipped: Optional[torch.Tensor] = None):
    """One launch of ``_fwd_kernel``'s port on CUDA tensors -> ``(o, lse)``
    (lse ``None`` unless ``with_lse``).  ``skipped``, a one-element int32
    tensor on the card or None: the kernel adds to it the (work item, key
    tile) pairs it skips, that is the pairs :func:`fwd_tile_plan` skips at
    the plan's ``rows`` and ``keys``, once per KV head and head chunk."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    q, k, v, q_pos, k_pos = q.contiguous(), k.contiguous(), v.contiguous(), _i32(q_pos), _i32(k_pos)
    dtype = _check_qkv(q, k, v, q_pos, k_pos, (b, s, h, hd), (b, t, kv, hd), (b, s))
    q, k, v = _aligned(q, k, v)
    audit_gate(FORWARD_KERNEL.name, "flash", hd=hd, dtype=q.dtype)
    out = torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    FORWARD_KERNEL.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        _skipped_ptr(skipped, q.device), dtype, b, s, t, h, kv, hd, int(bool(causal)),
        _window(window), float(softcap or 0.0), float(scale), sm_count(q.device),
    )
    return out, lse


def flash_attention_fwd(q, k, v, q_pos, k_pos, causal=True, window=None, softcap=None,
                        scale=1.0, *, with_lse=False):
    """The forward alone: ``(o, lse)``, o (B,S,H,hd) f32 and, with
    ``with_lse``, lse (B,H,S) f32 (else ``None``).  The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        got = attend(q, k, v, q_pos, k_pos, causal=causal, window=window, softcap=softcap,
                     scale=scale, with_lse=with_lse)
        return got if with_lse else (got, None)
    return launch_forward(q, k, v, q_pos, k_pos, causal=causal, window=window, softcap=softcap,
                          scale=scale, with_lse=with_lse)


def _bwd_operands(q, k, v, q_pos, k_pos, do, lse, dd):
    """Checked, contiguous operands of the two backward kernels: their
    pointers, the dtype code, the shape, and the tensors (held by the caller
    across its launch)."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    q, k, v, q_pos, k_pos = q.contiguous(), k.contiguous(), v.contiguous(), _i32(q_pos), _i32(k_pos)
    dtype = _check_qkv(q, k, v, q_pos, k_pos, (b, s, h, hd), (b, t, kv, hd), (b, s))
    do, lse, dd = (x.to(torch.float32).contiguous() for x in (do, lse, dd))
    check_operand(do, "do", torch.float32, (b, s, h, hd), q.device)
    check_operand(lse, "lse", torch.float32, (b, h, s), q.device)
    check_operand(dd, "dd", torch.float32, (b, h, s), q.device)
    # the kernels copy rows of q, k, v and do 16 bytes at a time
    q, k, v, do = _aligned(q, k, v, do)
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, dd, q_pos, k_pos)]
    return ptrs, dtype, (b, s, t, h, kv, hd), (q, k, v, q_pos, k_pos, do, lse, dd)


def flash_attention_bwd_dq(q, k, v, q_pos, k_pos, do, lse, dd, causal=True, window=None,
                           softcap=None, scale=1.0) -> torch.Tensor:
    """One launch of ``_dq_kernel``'s port on CUDA tensors -> dq (B,S,H,hd) f32."""
    ptrs, dtype, (b, s, t, h, kv, hd), _keep = _bwd_operands(q, k, v, q_pos, k_pos, do, lse, dd)
    audit_gate(DQ_KERNEL.name, "flash", hd=hd, dtype=_keep[0].dtype)
    dq = torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)
    DQ_KERNEL.launch(q.device, *ptrs, dq.data_ptr(), dtype, b, s, t, h, kv, hd,
                     int(bool(causal)), _window(window), float(softcap or 0.0), float(scale))
    return dq


def flash_attention_bwd_dkv(q, k, v, q_pos, k_pos, do, lse, dd, causal=True, window=None,
                            softcap=None, scale=1.0):
    """One launch of ``_dkv_kernel``'s port on CUDA tensors -> (dk, dv) (B,T,KV,hd) f32."""
    ptrs, dtype, (b, s, t, h, kv, hd), _keep = _bwd_operands(q, k, v, q_pos, k_pos, do, lse, dd)
    audit_gate(DKV_KERNEL.name, "flash", hd=hd, dtype=_keep[0].dtype)
    dk = torch.empty((b, t, kv, hd), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    DKV_KERNEL.launch(q.device, *ptrs, dk.data_ptr(), dv.data_ptr(), dtype, b, s, t, h, kv, hd,
                      int(bool(causal)), _window(window), float(softcap or 0.0), float(scale))
    return dk, dv


def flash_attention_bwd(q, k, v, q_pos, k_pos, o, lse, do, causal=True, window=None,
                        softcap=None, scale=1.0):
    """The reference's ``_bwd``: (dq, dk, dv) float32 from the forward's
    residuals.  CUDA tensors: ``dd = sum(do * o)`` here, then the dq and the
    dk/dv kernels; CPU tensors: :func:`flash_attention_bwd_plain`."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, q_pos, k_pos, o, lse, do, **kw)
    do = do.to(torch.float32)
    dd = torch.einsum("bshd,bshd->bhs", do, o.to(torch.float32))
    dq = flash_attention_bwd_dq(q, k, v, q_pos, k_pos, do, lse, dd, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, q_pos, k_pos, do, lse, dd, **kw)
    return dq, dk, dv


class FlashBackward(torch.autograd.Function):
    """``forward(q, k, v, q_pos, k_pos, fwd, bwd_kw)``: ``o, lse = fwd(q, k, v,
    q_pos, k_pos)``, returns o and saves lse; the backward is
    :func:`flash_attention_bwd` on ``(o, lse)``, cast to the input dtypes as
    the reference's ``_bwd`` does.  The exact flash forward and the
    approximate one (straight-through) share it."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, fwd, bwd_kw):
        o, lse = fwd(q, k, v, q_pos, k_pos)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, o, lse)
        ctx.bwd_kw = bwd_kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, k_pos, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, q_pos, k_pos, o, lse, do, **ctx.bwd_kw)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def flash_attention(q, k, v, q_pos, k_pos, causal=True, window=None, softcap=None,
                    scale=1.0) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,KV,hd), positions (B,S)/(B,T) -> (B,S,H,hd) f32.

    Differentiable in q, k and v: when autograd will ask for a gradient the
    forward also writes lse and the backward runs the dq and dk/dv kernels
    (their plain version on the CPU); otherwise (serving) no lse is made."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if not needs_grad(q, k, v):
        return flash_attention_fwd(q, k, v, q_pos, k_pos, **kw)[0]
    fwd = lambda *a: flash_attention_fwd(*a, **kw, with_lse=True)
    return FlashBackward.apply(q, k, v, q_pos, k_pos, fwd, kw)


def launch_decode(q, k, v, q_pos, k_pos, *, window=None, softcap=None, scale=1.0,
                  skipped: Optional[torch.Tensor] = None, with_lse: bool = False):
    """One launch of ``_decode_kernel``'s port on CUDA tensors -> (B,H,hd)
    f32, and with ``with_lse`` also lse (B, H) f32 over the slots given
    (the part a sequence shard of the cache adds, :func:`combine_ranges`).
    ``skipped``, a one-element int32 tensor on the card or None: the
    kernel adds to it the (batch row, KV head, chunk) triples it skips,
    that is the chunks :func:`decode_chunk_plan` leaves out, once per KV
    head."""
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    q, q_pos, k_pos = q.contiguous(), _i32(q_pos), _i32(k_pos)
    dtype = _check_qkv(q, k, v, q_pos, k_pos, (b, h, hd), (b, t, kv, hd), (b,))
    if h // kv > MAX_GROUP:
        raise ValueError(f"flash_decode takes up to {MAX_GROUP} query heads per KV head")
    k, v = _aligned(k, v)
    dev = q.device
    audit_gate(DECODE_KERNEL.name, "flash", hd=hd, dtype=q.dtype)
    # the chunks' partials, (acc[hd], m, l) per (batch row, query head,
    # chunk), in a buffer kept for every call: room for the most chunks the
    # kernel's split makes, so the split is decided in the kernel alone
    ws = float_scratch(dev, b * h * DEC_MAX_CHUNKS * (hd + 2))
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h), dtype=torch.float32, device=dev) if with_lse else None
    DECODE_KERNEL.launch(
        dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), ws.data_ptr(), ws.numel(),
        tile_counters(dev, b * kv).data_ptr(), _skipped_ptr(skipped, dev), dtype, b, t, h, kv,
        hd, _window(window), float(softcap or 0.0), float(scale), sm_count(dev),
    )
    return (out, lse) if with_lse else out


def flash_decode(q, k, v, q_pos, k_pos, *, window=None, softcap=None,
                 scale=1.0, with_lse=False):
    """q (B,H,hd), k/v (B,T,KV,hd) cache, q_pos (B,), k_pos (B,T) -> (B,H,hd) f32,
    and with ``with_lse`` also lse (B, H) f32 over these slots."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, q_pos, k_pos, window=window, softcap=softcap,
                                  scale=scale, with_lse=with_lse)
    return launch_decode(q, k, v, q_pos, k_pos, window=window, softcap=softcap, scale=scale,
                         with_lse=with_lse)
