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
from repro_torch.engine import artifacts
from repro_torch.kernels.build import SMEM_PER_BLOCK, CudaKernel, check_operand
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS, NEG_INF, FlashBackward, allow_mask, needs_grad,
)

__all__ = [
    "ATTN_MODES", "BITEXACT_KERNEL", "LOWRANK_KERNEL", "MAX_ATTN_N", "KernelOperands",
    "approx_attention_plain", "approx_flash_attention", "attn_tiles", "bitexact_tile",
    "kernel_operands", "launch_kernel", "lowrank_tile", "online_update", "prepare",
    "quant_signed", "validate_attn_mode",
]

ATTN_MODES = ("bitexact", "lowrank")
DEFAULT_BQ = 128
DEFAULT_BK = 128
BITEXACT_BK = 64  # the reference's VMEM-certified key block for bitexact
MAX_ATTN_N = 8  # both modes gather (2^n, ...) tables
MAX_BK = 128  # the kernel stages at most this many keys per block
_ROWS = 16  # csrc/approx_attention.cu kBQ
_KEY_CHUNK = 16  # csrc/approx_attention.cu kKC (lowrank)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (6 operands, table, q_pos, k_pos, scales, out, lse, B, S, T, H, KV, hd, n, bk, causal,
#  window, softcap, scale, [rank,] device, stream)
BITEXACT_KERNEL = CudaKernel(
    "approx_attention_bitexact", "approx_attention_bitexact_launch",
    [_P] * 12 + [_I] * 10 + [_F, _F, _I, _P], source="approx_attention",
)
LOWRANK_KERNEL = CudaKernel(
    "approx_attention_lowrank", "approx_attention_lowrank_launch",
    [_P] * 12 + [_I] * 10 + [_F, _F, _I, _I, _P], source="approx_attention",
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
    the reference does for a bf16 input."""
    qp = quantization.calibrate_absmax(x.detach(), bits=n)
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


# ---------------------------------------------------------------- plain
def approx_attention_plain(q, k, v, q_pos, k_pos, *, mode="lowrank", n=8, t=4,
                           fix_to_1=True, rank=8, causal=True, window=None, softcap=None,
                           scale=1.0, bk=None, with_lse=False):
    """The reference's ``approx_attention_reference`` on tensors: query
    tiles of ``DEFAULT_BQ`` rows (all heads at once; rows are independent),
    key blocks of ``bk`` in order, the key side zero-padded to a block
    multiple with ``k_pos = -1``.  With ``with_lse`` it returns ``(o,
    lse)``, lse (B, H, S) = m + log(max(l, 1e-30)) as the kernel writes it."""
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
            m, l, acc = online_update(
                m, l, acc, s_int, allow[:, None, None], av_int, qk_scale=qk_scale,
                pv_scale=pv_scale, scale=scale, softcap=softcap, n=n)
        l = torch.clamp(l, min=1e-30)
        out[..., rows, :] = acc / l[..., None]
        lse[..., rows] = m + torch.log(l)
    out = out.reshape(b, h, s, hd).transpose(1, 2)
    return (out, lse.reshape(b, h, s)) if with_lse else out


# ---------------------------------------------------------------- kernel
def smem_bytes(mode: str, n: int, hd: int, rank: int) -> int:
    """``csrc/approx_attention.cu``'s dynamic shared memory per block."""
    rows, kc = _ROWS, _KEY_CHUNK
    stats = 4 * (2 * rows * MAX_BK + 3 * rows + MAX_BK)
    if mode == "bitexact":
        return 2 * (1 << (2 * n)) + 2 * rows * (hd + 4) + 2 * MAX_BK * (hd + 4) + stats
    wide = hd * rank
    return 4 * ((1 << n) * rank + rows * (hd + 1) + rows * (wide + 1)
                + kc * (hd + 1) + kc * (wide + 1)) + stats


class KernelOperands(NamedTuple):
    """What the kernel reads, built from q, k and v by :func:`kernel_operands`."""

    mode: str
    n: int
    rank: int
    q_shape: tuple  # (B, S, H, hd)
    k_shape: tuple  # (B, T, KV, hd)
    args: list  # the six operands of the mode's entry point
    table: torch.Tensor  # bitexact: the uint16 product table; lowrank: U
    scales: torch.Tensor  # [qk_scale, pv_scale]


def kernel_operands(q, k, v, *, mode, n, t, fix_to_1, rank) -> KernelOperands:
    """Quantize q, k, v (:func:`prepare`) into the kernel's operands, checked."""
    b, s, h, hd = q.shape
    tt, kv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of the built widths {HEAD_DIMS}")
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not split into groups over {kv} KV heads")
    nbytes = smem_bytes(mode, n, hd, rank)
    if nbytes > SMEM_PER_BLOCK:
        raise ValueError(f"approx attention ({mode}, n={n}, hd={hd}, rank={rank}) needs "
                         f"{nbytes} bytes of shared memory, over {SMEM_PER_BLOCK}")
    dev = q.device
    ops, (qk_scale, pv_scale) = prepare(mode, q, k, v, n=n, t=t, fix_to_1=fix_to_1, rank=rank)
    scales = torch.stack([qk_scale, pv_scale]).to(torch.float32).contiguous()
    if mode == "lowrank":
        table = ops[-1]
        args = [x.contiguous() for x in ops[:-1]]
        widths = (hd, hd, hd, hd * rank, hd * rank, rank * hd)
        sides = ((b, s, h), (b, tt, kv), (b, tt, kv), (b, s, h), (b, tt, kv), (b, tt, kv))
        for name, x, w_, lead in zip(("qi", "ki", "vi", "ueq", "vek", "vev"), args, widths,
                                     sides):
            check_operand(x, name, torch.float32, (*lead, w_), dev)
        check_operand(table, "ut", torch.float32, (1 << n, rank), dev)
    else:
        table = artifacts.product_lut_u16(n, t, fix_to_1, dev)
        mq, sq, mk, sk, mv, sv = ops
        args = [mq.to(torch.uint8), sq.to(torch.int8), mk.to(torch.uint8), sk.to(torch.int8),
                mv.to(torch.uint8), sv.to(torch.int8)]
    return KernelOperands(mode, n, rank, (b, s, h, hd), (b, tt, kv, hd), args, table, scales)


def launch_kernel(ops: KernelOperands, q_pos, k_pos, *, bk, causal, window, softcap,
                  scale, with_lse=False):
    """One launch of the mode's kernel on prepared operands -> (B, S, H, hd)
    f32, or ``(o, lse)`` with ``with_lse`` (lse (B, H, S) f32)."""
    b, s, h, hd = ops.q_shape
    tt, kv = ops.k_shape[1], ops.k_shape[2]
    if not 1 <= bk <= MAX_BK:
        raise ValueError(f"key block {bk} outside [1, {MAX_BK}]")
    dev = ops.scales.device
    q_pos, k_pos = q_pos.to(torch.int32).contiguous(), k_pos.to(torch.int32).contiguous()
    check_operand(q_pos, "q_pos", torch.int32, (b, s), dev)
    check_operand(k_pos, "k_pos", torch.int32, (b, tt), dev)
    lowrank = ops.mode == "lowrank"
    kernel, tail = (LOWRANK_KERNEL, [ops.rank]) if lowrank else (BITEXACT_KERNEL, [])
    out = torch.empty((b, s, h, hd), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev) if with_lse else None
    kernel.launch(
        dev, *(x.data_ptr() for x in ops.args), ops.table.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), ops.scales.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, tt, h, kv, hd, ops.n, bk,
        int(bool(causal)), -1 if window is None else int(window), float(softcap or 0.0),
        float(scale), *tail,
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
