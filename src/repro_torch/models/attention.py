"""Multi-head attention: GQA, RoPE, qk-norm, softcap, sliding window, KV cache.

Counterpart of ``repro/models/attention.py`` on its plain path
(``attn_impl="xla"``): heads are repeated from KV to H at use (the cache
stays unrepeated), prefill uses the direct softmax or, for long
sequences, the blockwise online softmax, and decode reads the cache with
per-row positions.  ``attn_impl="pallas"`` names the flash-attention
kernels, which a later slice ports; it raises here.

The cache is written in place (an indexed write into the row's slots)
where the reference returns an updated copy: JAX arrays are immutable,
torch tensors need not be, and the in-place write saves a full cache copy
per layer and step.  Callers hold the same cache object before and after.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import Ctx

__all__ = ["KVCache", "init_attn", "attention", "init_kv_cache"]

NEG_INF = -2.3819763e38  # bf16-safe large negative (the reference's value)
Q_CHUNK = 1024
K_CHUNK = 1024


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KV, hd)
    v: torch.Tensor


def init_attn(cfg: ModelConfig, dtype, device, generator) -> dict:
    d, hq, hkv = cfg.d_model, cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    p = {
        "wq": layers.normal_init((d, hq), d**-0.5, dtype, device, generator),
        "wk": layers.normal_init((d, hkv), d**-0.5, dtype, device, generator),
        "wv": layers.normal_init((d, hkv), d**-0.5, dtype, device, generator),
        "wo": layers.normal_init((hq, d), hq**-0.5, dtype, device, generator),
    }
    if cfg.use_qk_norm:
        p["q_norm_scale"] = torch.zeros((cfg.head_dim,), dtype=dtype, device=device)
        p["k_norm_scale"] = torch.zeros((cfg.head_dim,), dtype=dtype, device=device)
    return p


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device) -> KVCache:
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def _write_rows(cache: torch.Tensor, update: torch.Tensor, starts: torch.Tensor) -> None:
    """In place: row i's update lands at sequence offset ``starts[i]``
    (clamped so the update fits, as ``dynamic_update_slice`` clamps)."""
    b, s = update.shape[:2]
    starts = torch.clamp(starts, 0, cache.shape[1] - s)
    idx = starts[:, None] + torch.arange(s, device=cache.device)[None, :]
    rows = torch.arange(b, device=cache.device)[:, None]
    cache[rows, idx] = update.to(cache.dtype)


def _allow(q_pos, k_pos, *, causal: bool, window: Optional[int]):
    """(B, Sq, Sk) boolean allow-mask from position ids."""
    m = k_pos[:, None, :] >= 0  # -1 marks unwritten cache slots
    if causal:
        m = m & (q_pos[:, :, None] >= k_pos[:, None, :])
    if window is not None:
        m = m & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    return m


def _scores(q, k, softcap, scale):
    s = torch.einsum("bqhd,bthd->bhqt", q.to(torch.float32), k.to(torch.float32)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    return s


def _attend_direct(q, k, v, q_pos, k_pos, *, causal, window, softcap, scale):
    logits = _scores(q, k, softcap, scale)
    allow = _allow(q_pos, k_pos, causal=causal, window=window)
    logits = torch.where(allow[:, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqt,bthd->bqhd", probs, v.to(torch.float32))


def _attend_flash(q, k, v, q_pos, k_pos, *, causal, window, softcap, scale,
                  q_chunk=Q_CHUNK, k_chunk=K_CHUNK):
    """Blockwise online softmax; q (B,S,H,hd), k/v (B,T,H,hd)."""
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
            allow = _allow(qpb, k_pos[:, k0:k0 + k_chunk], causal=causal, window=window)
            logits = torch.where(allow[:, None, :, :], logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqt,bthd->bhqd", p, vb.to(torch.float32))
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2))  # (B, qc, H, hd)
    return torch.cat(outs, dim=1)


def attention(
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    ctx: Ctx,
    *,
    local: bool = False,
    causal: bool = True,
    cache: Optional[KVCache] = None,
    cache_pos=None,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention over ``x`` (B, S, D) at ``positions`` (B, S).

    With a cache, ``cache_pos`` is the write offset: a scalar (every row
    writes at the same slot) or a per-row (B,) tensor, in which case
    ``positions`` carry each row's true positions and slot j of row i
    holds true position ``j - offset_i`` with ``offset_i = cache_pos_i +
    S - 1 - positions[i, -1]``; slots outside ``[offset_i, cache_pos_i +
    S - 1]`` are masked.  Returns ``(out, cache)``.
    """
    cfg = ctx.cfg
    if cfg.attn_impl == "pallas":
        raise NotImplementedError(
            "attn_impl='pallas' runs the flash-attention kernels, which are not "
            "ported yet (ROADMAP.md, 'TPU kernels to port' items 6-9)"
        )
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kvh

    q = layers.dense(x, params["wq"], ctx, "attn").reshape(b, s, h, hd)
    k = layers.dense(x, params["wk"], ctx, "attn").reshape(b, s, kvh, hd)
    v = layers.dense(x, params["wv"], ctx, "attn").reshape(b, s, kvh, hd)
    if cfg.use_qk_norm and "q_norm_scale" in params:
        q = layers.rms_norm(q, params["q_norm_scale"], cfg.norm_eps)
        k = layers.rms_norm(k, params["k_norm_scale"], cfg.norm_eps)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)

    decode = s == 1 and cache is not None
    if cache is not None:
        t = cache.k.shape[1]
        per_row = torch.is_tensor(cache_pos) and cache_pos.ndim >= 1
        if per_row:
            starts = cache_pos.to(torch.int64)
        else:
            starts = torch.full((b,), int(cache_pos), dtype=torch.int64, device=x.device)
        _write_rows(cache.k, k, starts)
        _write_rows(cache.v, v, starts)
        k, v = cache.k, cache.v
        jj = torch.arange(t, device=x.device)[None, :].expand(b, t)
        if per_row:
            last = starts + (s - 1)  # physical slot of the newest token
            offset = last - positions[:, -1].to(torch.int64)  # per-row left pad
            k_pos = torch.where(
                (jj >= offset[:, None]) & (jj <= last[:, None]), jj - offset[:, None], -1
            )
        else:
            k_pos = torch.where(jj <= int(cache_pos) + s - 1, jj, -1)
    else:
        k_pos = positions
    q_pos = positions

    window = cfg.local_window if local else None
    scale = hd**-0.5
    softcap = cfg.attn_logit_softcap
    if g > 1:  # GQA: repeat kv to the flat head axis (the cache stays unrepeated)
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if not decode and (s > Q_CHUNK or k.shape[1] > 4 * K_CHUNK):
        out = _attend_flash(q, k, v, q_pos, k_pos, **kw)
    else:
        out = _attend_direct(q, k, v, q_pos, k_pos, **kw)
    out = out.reshape(b, s, h * hd).to(x.dtype)
    return layers.dense(out, params["wo"], ctx, "attn"), cache
