"""Multi-head attention: GQA, RoPE/M-RoPE, qk-norm, softcap, sliding window, KV cache.

Counterpart of ``repro/models/attention.py``.  ``attn_impl`` picks the
path, as in the reference:

``"xla"``     the plain path: the direct softmax or, for long sequences,
              the blockwise online softmax, with query head h reading KV
              head h // g (the reference repeats k/v to H heads at use;
              the sums are the same).
``"pallas"``  the kernels of ``repro_torch.kernels``, k/v unrepeated:
              prefill through ``flash_attention``, or through
              ``approx_flash_attention`` when the ``attn`` target is
              approximated in ``bitexact``/``lowrank`` with a backend other
              than ``reference``; every decode step through
              ``flash_decode``.  On CPU tensors each kernel wrapper runs its
              plain version.

Decode reads the cache with per-row positions on both paths.  Under
M-RoPE (``cfg.use_mrope``) positions are (3, B, S) t/h/w ids: q and k
rotate by all three, and everything positional besides (the masks, the
per-row pad offset, the ``q_pos``/``k_pos`` of every kernel) reads the
t-ids, as the reference's ``mpos`` does.

The cache is written in place (an indexed write into the row's slots)
where the reference returns an updated copy: JAX arrays are immutable,
torch tensors need not be, and the in-place write saves a full cache copy
per layer and step.  Callers hold the same cache object before and after.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.approx_attention import (
    approx_flash_attention, attn_tiles, validate_attn_mode,
)
from repro_torch.kernels.flash_attention import attend, flash_attention, flash_decode
from repro_torch.models import layers
from repro_torch.models.layers import Ctx

__all__ = ["KVCache", "init_attn", "attention", "init_kv_cache"]


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


def _block(dim: int) -> int:
    """The largest power-of-two divisor of ``dim`` up to 512: the
    reference's kernel tile (``repro/models/attention.py:272-276``)."""
    b_ = 512
    while b_ > 1 and dim % b_:
        b_ //= 2
    return b_


def _pallas(q, k, v, q_pos, k_pos, *, decode, cfg, **kw):
    """The ``attn_impl="pallas"`` branches of the reference: k/v unrepeated."""
    if decode:
        return flash_decode(q[:, 0], k, v, q_pos[:, -1], k_pos, window=kw["window"],
                            softcap=kw["softcap"], scale=kw["scale"])[:, None]
    ap = cfg.approx.for_target("attn") if (
        cfg.approx.enabled and "attn" in cfg.approx.targets) else None
    if ap is not None and ap.mode in ("bitexact", "lowrank") and ap.backend != "reference":
        # the QK and AV contractions themselves through the multiplier; the
        # projections went through the engine already
        validate_attn_mode(ap.mode, ap.n)
        return approx_flash_attention(
            q, k, v, q_pos, k_pos, ap.mode, ap.n, ap.t, ap.fix_to_1, ap.rank,
            bk=min(_block(k.shape[1]), attn_tiles(ap.mode)[1]), **kw)
    return flash_attention(q, k, v, q_pos, k_pos, **kw)


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
    """Self-attention over ``x`` (B, S, D) at ``positions`` (B, S), or (3,
    B, S) t/h/w ids under M-RoPE (the masks and caches read the t-ids).

    With a cache, ``cache_pos`` is the write offset: a scalar (every row
    writes at the same slot) or a per-row (B,) tensor, in which case
    ``positions`` carry each row's true positions and slot j of row i
    holds true position ``j - offset_i`` with ``offset_i = cache_pos_i +
    S - 1 - positions[i, -1]``; slots outside ``[offset_i, cache_pos_i +
    S - 1]`` are masked.  Returns ``(out, cache)``.
    """
    cfg = ctx.cfg
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q = layers.dense(x, params["wq"], ctx, "attn").reshape(b, s, h, hd)
    k = layers.dense(x, params["wk"], ctx, "attn").reshape(b, s, kvh, hd)
    v = layers.dense(x, params["wv"], ctx, "attn").reshape(b, s, kvh, hd)
    if cfg.use_qk_norm and "q_norm_scale" in params:
        q = layers.rms_norm(q, params["q_norm_scale"], cfg.norm_eps)
        k = layers.rms_norm(k, params["k_norm_scale"], cfg.norm_eps)
    if cfg.use_mrope:
        q = layers.mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = layers.mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        positions = positions[0]  # masks, pad offsets and kernels read the t-ids
    else:
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
    kw = dict(causal=causal, window=window, softcap=cfg.attn_logit_softcap, scale=hd**-0.5)
    if cfg.attn_impl == "pallas":
        out = _pallas(q, k, v, q_pos, k_pos, decode=decode, cfg=cfg, **kw)
    else:
        out = attend(q, k, v, q_pos, k_pos, decode=decode, **kw)
    out = out.reshape(b, s, h * hd).to(x.dtype)
    return layers.dense(out, params["wo"], ctx, "attn"), cache
