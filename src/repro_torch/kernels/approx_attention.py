"""Flash attention with the approximate multiplier inside QK and AV.

Counterpart of ``repro/kernels/approx_attention.py``.  Under a quality
tier the score (``q @ k^T``) and value (``p @ v``) contractions run
through the paper's multiplier inside the online-softmax loop over key
blocks:

``mode="bitexact"``  every scalar product of both contractions is a
                     product-table gather (n <= 8);
``mode="lowrank"``   each contraction is the exact integer product plus
                     the rank-r SVD correction, with ``U[p_int]`` gathered
                     inside the loop because the probabilities exist only
                     there.

Probabilities are quantized statically, ``p_int = round(p * (2^n - 1))``,
against the running max of the key blocks seen so far; the softmax
statistics (m, l) stay exact float32.  So the key-block size ``bk`` is
part of the function (another ``bk`` gives other integers), and both
versions walk the key blocks in order with the caller's ``bk``; the query
tile only orders independent rows.

:func:`approx_flash_attention` runs ``csrc/approx_attention.cu`` for CUDA
tensors and :func:`approx_attention_plain` for CPU tensors; there is no
other fallback.  The plain version ports ``approx_attention_reference``:
the same key-block partition and padding, the same update order, and
:func:`online_update` / :func:`bitexact_tile` / :func:`lowrank_tile` as
functions on tensors (batched over batch, head and query rows).

The kernels leave out the (query tile, key block) pairs that change no
row's (m, l, acc), by the masked-block rule set out in the CUDA source:
:func:`approx_tile_plan` gives those pairs from the positions (the tests
run the plain version without them, bit-identical to
:func:`approx_attention_plain`), and :func:`launch_plan` /
:func:`smem_bytes` give the launches, for tests on the CPU.

Gradients are straight-through, as the reference's ``custom_vjp``: the
forward (kernel or plain version) also returns lse = m + log(max(l,
1e-30)), and the exact flash-attention backward
(``flash_attention.flash_attention_bwd``: the dq and dk/dv kernels on the
card) runs on the approximate forward's ``(o, lse)``.  Its probabilities
are recomputed exactly against the approximate lse, so they need not sum
to 1; that is the reference's function and is not renormalised.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.core import quantization
from repro_torch.distributed import sharding
from repro_torch.engine import artifacts
from repro_torch.kernels.build import (
    SMEM_PER_BLOCK, CudaKernel, audit_gate, check_operand, sm_count,
)
from repro_torch.kernels.flash_attention import (
    NEG_INF, FlashBackward, _check_width, allow_mask, fwd_tile_plan, needs_grad,
)

__all__ = [
    "ATTN_MODES", "BITEXACT_KERNEL", "LOWRANK_KERNEL", "MAX_ATTN_N", "AttnPlan", "KernelOperands",
    "approx_attention_plain", "approx_flash_attention", "approx_tile_plan", "attn_tiles", "bitexact_tile", "built_launch_plan", "kernel_operands",
    "launch_kernel", "launch_plan", "lowrank_tile", "online_update", "prepare", "quant_signed",
    "smem_bytes", "validate_attn_mode",
]

ATTN_MODES = ("bitexact", "lowrank")
DEFAULT_BQ = 128
DEFAULT_BK = 128
BITEXACT_BK = 64  # the reference's VMEM-certified key block for bitexact
MAX_ATTN_N = 8  # both modes gather (2^n, ...) tables
MAX_BK = 128  # the kernels stage at most this many keys per block
# csrc/approx_attention.cu: bitexact blocks of 512 threads staging 64 key
# slots at a time, items of 16 TM row-heads; lowrank blocks of 256 threads,
# items of 32 row-heads
_BITEXACT_THREADS, _CHUNK, _TMS = 512, 64, (4, 2, 1)
_LOWRANK_THREADS, _LOWRANK_RH = 256, 32

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (mq, sq, mk, sk, mv, sv, table, q_pos, k_pos, scales, out, lse, skipped, B, S, T, H, KV, hd,
#  n, bk, causal, window, softcap, scale, [rank,] sms, device, stream)
BITEXACT_KERNEL = CudaKernel(
    "approx_attention_bitexact", "approx_attention_bitexact_launch",
    [_P] * 13 + [_I] * 10 + [_F, _F, _I, _I, _P], source="approx_attention",
)
LOWRANK_KERNEL = CudaKernel(
    "approx_attention_lowrank", "approx_attention_lowrank_launch",
    [_P] * 13 + [_I] * 10 + [_F, _F, _I, _I, _I, _P], source="approx_attention",
)


def attn_tiles(mode: str) -> tuple[int, int]:
    """The reference's default (bq, bk) for ``mode``."""
    if mode == "bitexact":
        return DEFAULT_BQ, BITEXACT_BK
    return DEFAULT_BQ, DEFAULT_BK


def validate_attn_mode(mode: str, n: int) -> None:
    if mode not in ATTN_MODES:
        raise ValueError(f"approx attention supports modes {ATTN_MODES}, got {mode!r}")
    if n > MAX_ATTN_N:
        raise ValueError(
            f"approx attention gathers (2^n, ...) tables in shared memory, which "
            f"needs n <= {MAX_ATTN_N} (got n={n})")


# ---------------------------------------------------------- shared tile math
def _divisor(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d divisor on ``like``'s device: CUDA divides by a host scalar as
    a multiply by its reciprocal, the kernel and the reference divide."""
    return torch.full((), float(value), dtype=torch.float32, device=like.device)


def online_update(m, l, acc, s_int, allow, av_int, *, qk_scale, pv_scale, scale, softcap, n):
    """One key-block step of the approximate online softmax (the
    reference's ``_online_update``); rows on the second-to-last axis."""
    s = s_int * (qk_scale * scale)
    if softcap:
        s = torch.tanh(s / _divisor(softcap, s)) * softcap
    s = torch.where(allow, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    p_int = torch.round(p * ((1 << n) - 1)).to(torch.int64)
    acc_new = acc * corr[..., None] + av_int(p_int) * pv_scale
    return m_new, l_new, acc_new


def lowrank_tile(qi, ki, vi, ueq, vek, vev, ut, *, rank):
    """(s_int, av_int) for one lowrank tile pair, leading axes batched.

    qi (..., bq, hd), ki/vi (..., bk, hd): signed integer values (f32);
    ueq (..., bq, hd*r), vek (..., bk, hd*r): signed error embeddings;
    vev (..., bk, r*hd): V-side embedding of v, (r, hd) C-flattened;
    ut (2^n, r): the U factor, gathered by quantized p.
    """
    bq = qi.shape[-2]
    bk, hd = vi.shape[-2:]
    s_int = qi @ ki.transpose(-1, -2) + ueq @ vek.transpose(-1, -2)
    vev2 = vev.reshape(*vev.shape[:-2], bk * rank, hd)

    def av_int(p_int):
        up = ut[p_int].reshape(*p_int.shape[:-2], bq, bk * rank)
        return p_int.to(torch.float32) @ vi + up @ vev2

    return s_int, av_int


def bitexact_tile(mq, sq, mk, sk, mv, sv, lut, *, n):
    """(s_int, av_int) for one bitexact tile pair, leading axes batched:
    every scalar product a product-table gather (int64 magnitudes, f32
    signs, the table as f32), summed in float32 like the reference (exact:
    products < 2^16, at most 128 terms)."""
    base = 1 << n
    idx = mq[..., :, None, :] * base + mk[..., None, :, :]  # (..., bq, bk, hd)
    s_int = (lut[idx] * (sq[..., :, None, :] * sk[..., None, :, :])).sum(dim=-1)

    def av_int(p_int):
        idx2 = p_int[..., :, :, None] * base + mv[..., None, :, :]
        return (lut[idx2] * sv[..., None, :, :]).sum(dim=-2)

    return s_int, av_int


# ------------------------------------------------------------ operand prep
def quant_signed(x, n):
    """Per-tensor sign-magnitude quantization: (mag int32, sign f32, signed
    values f32, scale).  The scale is calibrated in ``x``'s own dtype, as
    the reference does for a bf16 input, and global over the ranks the
    batch is split over (``sharding.global_max``)."""
    qp = quantization.calibrate_absmax(x.detach(), bits=n, reduce=sharding.global_max)
    mag, sign = quantization.quantize(x, qp)
    sign = sign.to(torch.float32)
    return mag, sign, mag.to(torch.float32) * sign, qp.scale


def prepare(mode, q, k, v, *, n, t, fix_to_1, rank):
    """The reference's ``_prepare``: quantize q, k and v (k and v over the
    whole tensor passed in) and build the mode's operands.

    Returns ``(ops, (qk_scale, pv_scale))``.  bitexact: ``(mq, sq, mk, sk,
    mv, sv)`` with int32 magnitudes and f32 signs; lowrank: ``(qi, ki, vi,
    ueq, vek, vev, ut)`` in f32.
    """
    mq, sq, qi, scale_q = quant_signed(q, n)
    mk, sk, ki, scale_k = quant_signed(k, n)
    mv, sv, vi, scale_v = quant_signed(v, n)
    qk_scale = scale_q * scale_k
    pv_scale = scale_v / _divisor((1 << n) - 1, scale_v)
    if mode == "lowrank":
        u, vf, _ = artifacts.svd_factors(n, t, rank, fix_to_1, q.device)
        b, s, h, hd = q.shape
        tt, kv = k.shape[1], k.shape[2]
        ueq = (u[mq.to(torch.int64)] * sq[..., None]).reshape(b, s, h, hd * rank)
        vek = (vf[mk.to(torch.int64)] * sk[..., None]).reshape(b, tt, kv, hd * rank)
        vev = (vf[mv.to(torch.int64)] * sv[..., None]).transpose(-1, -2)
        vev = vev.reshape(b, tt, kv, rank * hd)
        return (qi, ki, vi, ueq, vek, vev, u), (qk_scale, pv_scale)
    return (mq, sq, mk, sk, mv, sv), (qk_scale, pv_scale)


def _pad_keys(x, tp):
    """Zero-pad the key axis (1) of a (B, T, ...) tensor to ``tp``."""
    if x.shape[1] == tp:
        return x
    pad = torch.zeros((x.shape[0], tp - x.shape[1], *x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=1)


def _q_side(x, kv):
    """(B, S, H, w) -> (B, KV, g, S, w)."""
    b, s, h, w = x.shape
    return x.reshape(b, s, kv, h // kv, w).permute(0, 2, 3, 1, 4)


def _k_side(x):
    """(B, T, KV, w) -> (B, KV, 1, T, w)."""
    return x.permute(0, 2, 1, 3)[:, :, None]


# ------------------------------------------------------ the masked-block rule
def approx_tile_plan(q_pos, k_pos, *, bk: int, rows: int, causal: bool,
                     window: Optional[int]) -> torch.Tensor:
    """The (query tile, key block) pairs the kernels compute, by the rule
    they follow (``csrc/approx_attention.cu``), from positions alone.

    Returns ``live`` (B, ceil(S / rows), ceil(T / bk)) bool.  A pair is
    skipped (``False``) when (a) no row of the tile may attend any slot of
    the block, judged from the tile's least and greatest position against
    each written slot, and (b) every row of the tile has an allowed slot
    somewhere in T.  A skipped pair leaves every row's (m, l, acc) as they
    were.  The exact forward's rule (:func:`fwd_tile_plan`), at key tiles of
    ``bk``.
    """
    return fwd_tile_plan(q_pos, k_pos, rows=rows, keys=bk, causal=causal, window=window)


# ---------------------------------------------------------------- plain
def _blockwise(q, k, v, q_pos, k_pos, *, mode, n, t, fix_to_1, rank, causal, window, softcap,
               scale, bk, with_lse, _keep=None):
    """The reference's blockwise loop.  ``_keep`` (B, S, key blocks) bool,
    for the tests of the masked-block rule only: where it is False the
    block leaves the row's (m, l, acc) as they were."""
    validate_attn_mode(mode, n)
    b, s, h, hd = q.shape
    tt, kv = k.shape[1], k.shape[2]
    bq_, bk_ = min(DEFAULT_BQ, s), min(bk or attn_tiles(mode)[1], tt)
    tp = -(-tt // bk_) * bk_
    ops, (qk_scale, pv_scale) = prepare(mode, q, k, v, n=n, t=t, fix_to_1=fix_to_1, rank=rank)
    kp = torch.cat([k_pos, torch.full((b, tp - tt), -1, dtype=k_pos.dtype,
                                      device=k_pos.device)], dim=1)
    if mode == "lowrank":
        qi, ki, vi, ueq, vek, vev, ut = ops
        q_ops = [_q_side(x, kv) for x in (qi, ueq)]
        k_ops = [_k_side(_pad_keys(x, tp)) for x in (ki, vi, vek, vev)]
    else:
        mq, sq, mk, sk, mv, sv = ops
        lut = artifacts.product_lut_u16(n, t, fix_to_1, q.device)
        lut = (lut.view(torch.int16).to(torch.int64) & 0xFFFF).to(torch.float32)
        q_ops = [_q_side(mq.to(torch.int64), kv), _q_side(sq, kv)]
        k_ops = [_k_side(_pad_keys(x, tp)) for x in (mk.to(torch.int64), sk,
                                                     mv.to(torch.int64), sv)]
    out = torch.empty((b, kv, h // kv, s, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, kv, h // kv, s), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, bq_):
        rows = slice(q0, q0 + bq_)
        nr = min(bq_, s - q0)
        m = torch.full((b, kv, h // kv, nr), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((*m.shape, hd), dtype=torch.float32, device=q.device)
        for k0 in range(0, tp, bk_):
            keys = slice(k0, k0 + bk_)
            qo = [x[..., rows, :] for x in q_ops]
            ko = [x[..., keys, :] for x in k_ops]
            if mode == "lowrank":
                s_int, av_int = lowrank_tile(qo[0], ko[0], ko[1], qo[1], ko[2], ko[3], ut,
                                             rank=rank)
            else:
                s_int, av_int = bitexact_tile(qo[0], qo[1], ko[0], ko[1], ko[2], ko[3], lut,
                                              n=n)
            allow = allow_mask(q_pos[:, rows], kp[:, keys], causal=causal, window=window)
            state = online_update(
                m, l, acc, s_int, allow[:, None, None], av_int, qk_scale=qk_scale,
                pv_scale=pv_scale, scale=scale, softcap=softcap, n=n)
            if _keep is None:
                m, l, acc = state
            else:
                keep = _keep[:, rows, k0 // bk_][:, None, None]  # (B, 1, 1, nr)
                m, l = (torch.where(keep, new, old) for new, old in zip(state, (m, l)))
                acc = torch.where(keep[..., None], state[2], acc)
        l = torch.clamp(l, min=1e-30)
        out[..., rows, :] = acc / l[..., None]
        lse[..., rows] = m + torch.log(l)
    out = out.reshape(b, h, s, hd).transpose(1, 2)
    return (out, lse.reshape(b, h, s)) if with_lse else out


def approx_attention_plain(q, k, v, q_pos, k_pos, *, mode="lowrank", n=8, t=4,
                           fix_to_1=True, rank=8, causal=True, window=None, softcap=None,
                           scale=1.0, bk=None, with_lse=False):
    """The reference's ``approx_attention_reference`` on tensors: query
    tiles of ``DEFAULT_BQ`` rows (all heads at once; rows are independent),
    key blocks of ``bk`` in order, the key side zero-padded to a block
    multiple with ``k_pos = -1``.  With ``with_lse`` it returns ``(o,
    lse)``, lse (B, H, S) = m + log(max(l, 1e-30)) as the kernel writes it."""
    return _blockwise(q, k, v, q_pos, k_pos, mode=mode, n=n, t=t, fix_to_1=fix_to_1,
                      rank=rank, causal=causal, window=window, softcap=softcap, scale=scale,
                      bk=bk, with_lse=with_lse)


# ---------------------------------------------------------------- kernel
class AttnPlan(NamedTuple):
    """One launch of an approximate attention kernel: its grid, threads per
    block, dynamic shared memory in bytes, and each work item's query rows
    and query heads (of one KV head's group)."""

    grid: tuple
    threads: int
    smem: int
    rows: int
    heads: int


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def _stats_bytes(rh: int) -> int:
    return _align16(4 * (4 * rh + MAX_BK + 4))


def _bitexact_rh(hd: int, tm: int) -> int:
    """Row-heads per bitexact item: 16 TM (32 TM at hd 16)."""
    return 16 * tm * (32 // min(32, hd))


def smem_bytes(mode: str, n: int, hd: int, rank: int, tm: int = 4) -> int:
    """``csrc/approx_attention.cu``'s dynamic shared memory per block:
    bitexact at row-tile factor ``tm`` (4, the most, by default), lowrank
    at ``rank``; kept in step with ``bitexact_smem`` / ``LowrankLayout``."""
    if mode == "bitexact":
        rh = _bitexact_rh(hd, tm)
        return (_align16(2 << (2 * n)) + 4 * hd * rh + 2 * _CHUNK * hd + 4 * rh * MAX_BK
                + _stats_bytes(rh))
    hdp, rh = max(hd, 32), _LOWRANK_RH
    tables = 16 * ((1 << n) + 1) * (-(-rank // 8) * 8)
    q_part = _align16(2 * rh * (hdp + 32) + 2 * hd * rh)
    k_part = 2 * MAX_BK * (hdp + 8) + 2 * hd * (MAX_BK + 4)
    v_part = 2 * hdp * (MAX_BK + 8) + 2 * MAX_BK * (hdp + 4)
    return (tables + q_part + _align16(max(k_part, v_part)) + 4 * rh * MAX_BK
            + rh * (MAX_BK + 32) + _stats_bytes(rh))


def _geometry(b: int, s: int, h: int, kv: int, rh: int) -> tuple[int, int, int]:
    """(items, rows, heads) of a launch whose items hold ``rh`` row-heads."""
    g = h // kv
    heads = min(g, rh)
    rows = rh // heads
    return b * kv * -(-g // heads) * -(-s // rows), rows, heads


def _check_fits(mode: str, n: int, hd: int, rank: int) -> None:
    """Raise ``TileBudgetError`` (a ``ValueError``) unless a block of
    ``mode`` fits the shared memory at its least (bitexact at TM = 1):
    ``analysis.smem.validate_attention``, the one model of a block's
    budget."""
    from repro_torch.analysis.smem import validate_attention

    validate_attention(mode, n, hd, rank)


def launch_plan(mode: str, b: int, s: int, t: int, h: int, kv: int, hd: int, n: int,
                rank: int, sms: int) -> AttnPlan:
    """The launch of ``mode``'s kernel on q (b, s, h, hd), k/v (b, t, kv, hd)
    with ``sms`` SMs: a persistent grid of min(items, sms) blocks; bitexact
    items hold 16 TM row-heads, TM = 4, 2 or 1 the largest whose block fits
    the shared memory (at hd 256 and n = 8 TM = 4 does not) and that gives
    every SM an item, else the smallest that fits; lowrank items 32."""
    _check_width(hd)
    validate_attn_mode(mode, n)
    _check_fits(mode, n, hd, rank)
    if mode == "bitexact":
        for tm in (tm for tm in _TMS if smem_bytes(mode, n, hd, rank, tm) <= SMEM_PER_BLOCK):
            items, rows, heads = _geometry(b, s, h, kv, _bitexact_rh(hd, tm))
            if items >= sms:
                break
        threads, smem = _BITEXACT_THREADS, smem_bytes(mode, n, hd, rank, tm)
    else:
        items, rows, heads = _geometry(b, s, h, kv, _LOWRANK_RH)
        threads, smem = _LOWRANK_THREADS, smem_bytes(mode, n, hd, rank)
    return AttnPlan((min(items, sms), 1, 1), threads, smem, rows, heads)


def built_launch_plan(mode: str, b: int, s: int, t: int, h: int, kv: int, hd: int, n: int,
                      rank: int, sms: int) -> AttnPlan:
    """The launch that the built ``csrc/approx_attention.cu`` makes for these
    arguments (its ``approx_attention_plan``), which :func:`launch_plan`
    must equal; builds the library, so it needs ``nvcc``."""
    fn = BITEXACT_KERNEL.library().approx_attention_plan
    fn.argtypes = [_I] * 10 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 7)()
    err = fn(ATTN_MODES.index(mode), b, s, t, h, kv, hd, n, rank, sms, out)
    if err != 0:
        raise ValueError(f"approx_attention_plan refused {mode} {(b, s, t, h, kv, hd, n, rank)}: "
                         f"CUDA error {err}")
    return AttnPlan(tuple(out[:3]), out[3], out[4], out[5], out[6])


class KernelOperands(NamedTuple):
    """What the kernel reads, built from q, k and v by :func:`kernel_operands`."""

    mode: str
    n: int
    rank: int
    q_shape: tuple  # (B, S, H, hd)
    k_shape: tuple  # (B, T, KV, hd)
    args: list  # magnitudes (uint8) and signs (int8) of q, k and v
    table: torch.Tensor  # bitexact: the uint16 product table; lowrank: U and V (2, 2^n, r)
    scales: torch.Tensor  # [qk_scale, pv_scale]
    t: int = 0  # the split the table or factors were built at


def kernel_operands(q, k, v, *, mode, n, t, fix_to_1, rank) -> KernelOperands:
    """Quantize q, k, v as :func:`prepare` does into the kernel's operands,
    checked: magnitudes and signs in both modes (lowrank builds its error
    embeddings in shared memory, from the U and V tables)."""
    b, s, h, hd = q.shape
    tt, kv = k.shape[1], k.shape[2]
    _check_width(hd)
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not split into groups over {kv} KV heads")
    validate_attn_mode(mode, n)
    _check_fits(mode, n, hd, rank)
    dev = q.device
    # both kernels read magnitudes and signs: prepare's bitexact operands
    ops, (qk_scale, pv_scale) = prepare("bitexact", q, k, v, n=n, t=t, fix_to_1=fix_to_1,
                                        rank=rank)
    scales = torch.stack([qk_scale, pv_scale]).to(torch.float32).contiguous()
    mq, sq, mk, sk, mv, sv = ops
    args = [mq.to(torch.uint8), sq.to(torch.int8), mk.to(torch.uint8), sk.to(torch.int8),
            mv.to(torch.uint8), sv.to(torch.int8)]
    if mode == "lowrank":
        u, vf, _ = artifacts.svd_factors(n, t, rank, fix_to_1, dev)
        table = torch.stack([u, vf]).to(torch.float32).contiguous()
        check_operand(table, "tables", torch.float32, (2, 1 << n, rank), dev)
    else:
        table = artifacts.product_lut_u16(n, t, fix_to_1, dev)
    return KernelOperands(mode, n, rank, (b, s, h, hd), (b, tt, kv, hd), args, table, scales, t)


def launch_kernel(ops: KernelOperands, q_pos, k_pos, *, bk, causal, window, softcap,
                  scale, with_lse=False, skipped: Optional[torch.Tensor] = None):
    """One launch of the mode's kernel on prepared operands -> (B, S, H, hd)
    f32, or ``(o, lse)`` with ``with_lse`` (lse (B, H, S) f32).

    ``skipped``, a one-element int32 tensor on the card or None: the kernel
    adds one to it for each (work item, key block) pair it skips, that is
    each pair :func:`approx_tile_plan` skips at the plan's ``rows``, once
    per KV head and head chunk (``-(-(H // KV) // plan.heads)``).
    """
    b, s, h, hd = ops.q_shape
    tt, kv = ops.k_shape[1], ops.k_shape[2]
    if not 1 <= bk <= MAX_BK:
        raise ValueError(f"key block {bk} outside [1, {MAX_BK}]")
    dev = ops.scales.device
    q_pos, k_pos = q_pos.to(torch.int32).contiguous(), k_pos.to(torch.int32).contiguous()
    check_operand(q_pos, "q_pos", torch.int32, (b, s), dev)
    check_operand(k_pos, "k_pos", torch.int32, (b, tt), dev)
    shapes = (ops.q_shape, ops.k_shape, ops.k_shape)
    for i, (name, x) in enumerate(zip(("mq", "sq", "mk", "sk", "mv", "sv"), ops.args)):
        check_operand(x, name, (torch.uint8, torch.int8)[i % 2], shapes[i // 2], dev)
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels load 16 bytes)")
    if skipped is not None:
        check_operand(skipped, "skipped", torch.int32, (1,), dev)
    lowrank = ops.mode == "lowrank"
    kernel, tail = (LOWRANK_KERNEL, [ops.rank]) if lowrank else (BITEXACT_KERNEL, [])
    audit_gate(kernel.name, f"attention:{ops.mode}", ops.n, ops.t, hd=hd, rank=ops.rank)
    out = torch.empty((b, s, h, hd), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev) if with_lse else None
    kernel.launch(
        dev, *(x.data_ptr() for x in ops.args), ops.table.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), ops.scales.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if skipped is None else skipped.data_ptr(), b, s, tt, h, kv, hd, ops.n, bk,
        int(bool(causal)), -1 if window is None else int(window), float(softcap or 0.0),
        float(scale), *tail, sm_count(dev),
    )
    return (out, lse) if with_lse else out


def approx_flash_attention(q, k, v, q_pos, k_pos, mode="lowrank", n=8, t=4, fix_to_1=True,
                           rank=8, causal=True, window: Optional[int] = None,
                           softcap: Optional[float] = None, scale=1.0,
                           bk=None) -> torch.Tensor:
    """Flash attention with approximate QK and AV contractions.

    q (B, S, H, hd), k/v (B, T, KV, hd), positions (B, S)/(B, T); returns
    (B, S, H, hd) f32.  ``bk`` (default: the mode's ``attn_tiles``) is the
    key block of the online softmax and changes the result.  The query
    tile does not: each version picks its own.  Differentiable in q, k and
    v, straight-through (see the module's note).
    """
    validate_attn_mode(mode, n)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)

    def forward(q, k, v, q_pos, k_pos, with_lse=True):
        if q.device.type == "cpu":
            return approx_attention_plain(q, k, v, q_pos, k_pos, mode=mode, n=n, t=t,
                                          fix_to_1=fix_to_1, rank=rank, bk=bk,
                                          with_lse=with_lse, **kw)
        ops = kernel_operands(q, k, v, mode=mode, n=n, t=t, fix_to_1=fix_to_1, rank=rank)
        return launch_kernel(ops, q_pos, k_pos, bk=min(bk or attn_tiles(mode)[1], k.shape[1]),
                             with_lse=with_lse, **kw)

    if not needs_grad(q, k, v):
        return forward(q, k, v, q_pos, k_pos, with_lse=False)
    return FlashBackward.apply(q, k, v, q_pos, k_pos, forward, kw)
