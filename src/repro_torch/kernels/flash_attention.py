"""Flash attention forward and flash decode, with GQA by head index.

Counterpart of ``repro/kernels/flash_attention.py`` (forward and decode;
the backward kernels are a later slice).  :func:`flash_attention` and
:func:`flash_decode` run the CUDA kernels of ``csrc/flash_attention.cu``
for CUDA tensors and the plain versions for CPU tensors; there is no
other fallback.  Layouts are the reference's: q (B, S, H, hd), k/v
(B, T, KV, hd) unrepeated, positions (B, S) / (B, T) with ``-1`` marking
an unwritten cache slot; decode takes q (B, H, hd) and q_pos (B,).  Both
return float32.  The reference's ``bq``/``bk``/``interpret`` arguments
have no counterpart: the tiles are the kernel's own, and they change only
the order of float32 sums.

The plain versions are the port's attention math, also used by
``models/attention.py`` on its plain path: the direct softmax, or the
blockwise online softmax for long sequences, with query head h reading KV
head h // g.  ``NEG_INF`` is the reference's finite large negative, never
-inf (see ``csrc/flash_attention.cu`` for why that matters).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel, check_operand

__all__ = [
    "DECODE_KERNEL", "FORWARD_KERNEL", "NEG_INF", "allow_mask", "attend",
    "flash_attention", "flash_attention_plain", "flash_decode", "flash_decode_plain",
]

NEG_INF = -2.3819763e38  # bf16-safe large negative (the reference's value)
Q_CHUNK = 1024
K_CHUNK = 1024
HEAD_DIMS = (16, 32, 64, 128)  # the head widths the kernels are built for
MAX_GROUP = 16  # flash_decode: query heads per KV head

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FORWARD_KERNEL = CudaKernel(
    "flash_attention", "flash_attention_launch",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
)
DECODE_KERNEL = CudaKernel(
    "flash_decode", "flash_decode_launch",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    source="flash_attention",
)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _attend_direct(q, k, v, q_pos, k_pos, *, causal, window, softcap, scale):
    logits = _scores(q, k, softcap, scale)
    allow = allow_mask(q_pos, k_pos, causal=causal, window=window)
    logits = torch.where(allow[:, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return _weighted_values(probs, v).transpose(1, 2)  # (B, S, H, hd)


def _attend_flash(q, k, v, q_pos, k_pos, *, causal, window, softcap, scale,
                  q_chunk=Q_CHUNK, k_chunk=K_CHUNK):
    """Blockwise online softmax over (q_chunk, k_chunk) tiles."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    q_chunk, k_chunk = min(q_chunk, s), min(k_chunk, t)
    if s % q_chunk or t % k_chunk:
        raise ValueError(f"sequence lengths ({s}, {t}) must divide the chunks")
    outs = []
    for q0 in range(0, s, q_chunk):
        qb, qpb = q[:, q0:q0 + q_chunk], q_pos[:, q0:q0 + q_chunk]
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, q_chunk, hd), dtype=torch.float32, device=q.device)
        for k0 in range(0, t, k_chunk):
            kb, vb = k[:, k0:k0 + k_chunk], v[:, k0:k0 + k_chunk]
            logits = _scores(qb, kb, softcap, scale)
            allow = allow_mask(qpb, k_pos[:, k0:k0 + k_chunk], causal=causal, window=window)
            logits = torch.where(allow[:, None, :, :], logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _weighted_values(p, vb)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2))  # (B, qc, H, hd)
    return torch.cat(outs, dim=1)


def attend(q, k, v, q_pos, k_pos, *, causal, window, softcap, scale, decode=False):
    """The plain attention: direct softmax, or blockwise past the chunk
    sizes (never at decode, as the reference's plain path)."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if not decode and (q.shape[1] > Q_CHUNK or k.shape[1] > 4 * K_CHUNK):
        return _attend_flash(q, k, v, q_pos, k_pos, **kw)
    return _attend_direct(q, k, v, q_pos, k_pos, **kw)


def flash_attention_plain(q, k, v, q_pos, k_pos, causal=True, window=None, softcap=None,
                          scale=1.0) -> torch.Tensor:
    return attend(q, k, v, q_pos, k_pos, causal=causal, window=window, softcap=softcap,
                  scale=scale)


def flash_decode_plain(q, k, v, q_pos, k_pos, *, window=None, softcap=None,
                       scale=1.0) -> torch.Tensor:
    out = attend(q[:, None], k, v, q_pos[:, None], k_pos, causal=True, window=window,
                 softcap=softcap, scale=scale, decode=True)
    return out[:, 0]


# -------------------------------------------------------------- wrappers
def refuse_gradient(name: str, *tensors) -> None:
    """The card has no backward kernels yet: asking for a gradient raises."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the backward kernels (_dq_kernel, _dkv_kernel) are not ported to "
            f"CUDA yet (ROADMAP.md, 'TPU kernels to port' item 7)"
        )


def _check_qkv(q, k, v, q_pos, k_pos, q_shape, k_shape, qp_shape):
    dev = q.device
    dtype = q.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"q has dtype {dtype}; the kernels take {list(_DTYPES)}")
    hd = q_shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of the built widths {HEAD_DIMS}")
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
    return x.to(torch.int32).contiguous()


def flash_attention(q, k, v, q_pos, k_pos, causal=True, window=None, softcap=None,
                    scale=1.0) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,KV,hd), positions (B,S)/(B,T) -> (B,S,H,hd) f32."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, k_pos, causal, window, softcap, scale)
    refuse_gradient("flash_attention", q, k, v)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    q, q_pos, k_pos = q.contiguous(), _i32(q_pos), _i32(k_pos)
    dtype = _check_qkv(q, k, v, q_pos, k_pos, (b, s, h, hd), (b, t, kv, hd), (b, s))
    out = torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)
    FORWARD_KERNEL.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), out.data_ptr(), dtype, b, s, t, h, kv, hd, int(bool(causal)),
        -1 if window is None else int(window), float(softcap or 0.0), float(scale),
    )
    return out


def flash_decode(q, k, v, q_pos, k_pos, *, window=None, softcap=None,
                 scale=1.0) -> torch.Tensor:
    """q (B,H,hd), k/v (B,T,KV,hd) cache, q_pos (B,), k_pos (B,T) -> (B,H,hd) f32."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, q_pos, k_pos, window=window, softcap=softcap,
                                  scale=scale)
    refuse_gradient("flash_decode", q, k, v)
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    q, q_pos, k_pos = q.contiguous(), _i32(q_pos), _i32(k_pos)
    dtype = _check_qkv(q, k, v, q_pos, k_pos, (b, h, hd), (b, t, kv, hd), (b,))
    if h // kv > MAX_GROUP:
        raise ValueError(f"flash_decode takes up to {MAX_GROUP} query heads per KV head")
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    DECODE_KERNEL.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), out.data_ptr(), dtype, b, t, h, kv, hd,
        -1 if window is None else int(window), float(softcap or 0.0), float(scale),
    )
    return out
