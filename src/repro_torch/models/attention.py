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

**Tensor parallelism** (placed parameters, ``distributed.sharding``).  q,
k and v come out of their column-parallel projections split by heads, as
the reference's ``constrain(q, DP, None, TP, None)`` places them; the
output is concatenated over this rank's heads and goes through the
row-parallel ``wo``.  Where the model axis splits ``wk``/``wv`` inside a
head (fewer KV heads than ranks: qwen3's 8 on 16) or not at all, k and v
are made whole (an all-gather of the columns, or the whole product with
its gradient added over the model group) and each rank keeps the KV heads
its query heads read.  Without a cache (training) each rank attends over
its heads alone; where ``wq`` too is split inside a head (qwen2-vl's 28
heads on 16), q is made whole as well, every rank attends with every
head, and keeps the columns of the output that its block of ``wo``
multiplies (the gradient of the others is zero there, and the all-gathers'
reduce-scatters add the ranks' parts).

With a cache the KV cache is split over its **sequence** axis
(``launch/specs.py``'s ``(DP, TP, None, None)``, the reference's
"flash-decode: shard the cache sequence axis over TP"): each rank holds
slots ``[r T/m, (r+1) T/m)`` of every KV head.  So the step is a
hand-over from heads to slots and back, with three collectives:

1. q, k and v are all-gathered over the model group along heads: every
   rank now holds every head of the new tokens.  A new token's k and v
   are written by the rank whose range holds its slot; rows written at
   per-row positions may land on different ranks, and a prefill's S slots
   spread over them.
2. Each rank attends with every query head over its own slots and also
   returns lse (``flash_decode(..., with_lse=True)``, the forward's lse,
   or the plain attention's).
3. The ranks' ``(o, lse)`` are all-gathered and combined in rank order
   (``kernels.flash_attention.combine_ranges``, the reference's finite
   ``NEG_INF`` kept), and each rank keeps its heads' o for ``wo``.

The approximate attention (``bitexact``/``lowrank`` on the ``attn``
target, ``attn_impl="pallas"``) at a prefill over a sequence-split cache:
its key block is part of the function (``attn_tiles``), so the ranks'
ranges are not combined.  Each rank all-gathers the cache's slots over
the model group and runs the kernel on its query heads over the whole K
and V (every head where the model axis does not split the output at
whole heads), as the reference replicates K and V over ``model`` and
runs the kernel on the heads-split q; the per-tensor scales of q, k and
v are the whole tensors' (``sharding.heads_split``).  The decode steps
run ``flash_decode`` over the ranges, as at every tier.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.kernels.approx_attention import (
    approx_flash_attention, attn_tiles, validate_attn_mode,
)
from repro_torch.kernels.flash_attention import (
    attend, combine_ranges, flash_attention, flash_attention_fwd, flash_decode,
)
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


def _write_range(cache: torch.Tensor, update: torch.Tensor, starts: torch.Tensor, base: int,
                 total: int) -> None:
    """:func:`_write_rows` on a sequence shard holding slots ``[base, base +
    cache.shape[1])`` of ``total``: only the (row, slot) pairs in this
    range change here.  The write has the update's shape on every rank, so
    the host never waits for the device to learn which pairs are its own: a
    row's positions outside the range are clamped to its nearest position
    inside (they write that slot's new value again), and a row with none
    inside writes its slot 0 back with the value it holds."""
    b, s = update.shape[:2]
    t = cache.shape[1]
    starts = torch.clamp(starts, 0, total - s)
    lo = torch.clamp(base - starts, 0, s)[:, None]  # the row's first position in range
    hi = torch.clamp(base + t - starts, 0, s)[:, None]  # one past its last
    pos = torch.arange(s, device=cache.device)[None, :].expand(b, s)
    pos = torch.clamp(torch.clamp(pos, lo, hi - 1), 0, s - 1)
    inside = hi > lo
    idx = torch.where(inside, starts[:, None] + pos - base, 0)
    rows = torch.arange(b, device=cache.device)[:, None]
    vals = torch.where(inside[..., None, None], update.to(cache.dtype)[rows, pos],
                       cache[:, :1])
    cache[rows, idx] = vals


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
    ap = _approx_attn(cfg)
    if ap is not None:
        # the QK and AV contractions themselves through the multiplier; the
        # projections went through the engine already
        validate_attn_mode(ap.mode, ap.n)
        return approx_flash_attention(
            q, k, v, q_pos, k_pos, ap.mode, ap.n, ap.t, ap.fix_to_1, ap.rank,
            bk=min(_block(k.shape[1]), attn_tiles(ap.mode)[1]), **kw)
    return flash_attention(q, k, v, q_pos, k_pos, **kw)


def _kv_heads(r: int, hl: int, g: int) -> tuple[int, int]:
    """The KV heads ``[lo, hi)`` that query heads ``[r hl, (r + 1) hl)`` read
    (head j reads KV head j // g)."""
    lo, hi = r * hl // g, ((r + 1) * hl - 1) // g + 1
    if (hi - lo) * g != hl and hi - lo != 1:
        raise ValueError(f"{hl} query heads a rank do not map onto whole groups of {g}")
    return lo, hi


def _tp_heads(t: torch.Tensor, ax, heads: int, hd: int) -> tuple[torch.Tensor, bool]:
    """A column-parallel q, k or v product (B, S, cols) as (tensor, whole):
    this rank's heads where the model axis splits the columns at whole
    heads, else every head (gathered, or the whole product with its
    gradient added over the model group)."""
    cols = t.shape[-1]
    if cols % hd == 0 and cols * ax.size == heads * hd:
        return t, False
    if cols == heads * hd:
        return sharding.copy_to(t, ax), True
    return sharding.all_gather(t, ax, -1), True


def _split_heads(q, k, v, ax, heads: int, kv_heads: int, hd: int) -> tuple:
    """Column-parallel q, k and v products (B, S, cols) as (q, k, v, q
    whole?, k/v whole?): this rank's heads where the model axis splits at
    whole heads (:func:`_tp_heads`), k and v made whole where q is."""
    q, q_whole = _tp_heads(q, ax, heads, hd)
    (k, whole), (v, _) = _tp_heads(k, ax, kv_heads, hd), _tp_heads(v, ax, kv_heads, hd)
    if q_whole and not whole:
        k, v = sharding.all_gather(k, ax, -1), sharding.all_gather(v, ax, -1)
        whole = True
    return q, k, v, q_whole, whole


def _approx_attn(cfg):
    """The attention target's approximation where the kernel path takes it, or None."""
    ap = cfg.approx.for_target("attn") if (
        cfg.approx.enabled and "attn" in cfg.approx.targets) else None
    if ap is not None and ap.mode in ("bitexact", "lowrank") and ap.backend != "reference":
        return ap
    return None


def combine_over(o: torch.Tensor, lse: torch.Tensor, ax) -> torch.Tensor:
    """Every rank's ``(o, lse)`` over its own slots, (B, S, H, hd) and (B,
    H, S), combined in rank order into the attention over all of them
    (``combine_ranges``; the module's note, 3)."""
    outs = sharding.all_gather(o[None], ax, 0)  # (m, B, S, H, hd)
    lses = sharding.all_gather(lse.transpose(1, 2)[None], ax, 0)  # (m, B, S, H)
    return combine_ranges(outs, lses)[0]


def _ranges_attention(q, k, v, q_pos, k_pos, *, decode, cfg, ax, cols, **kw):
    """Every query head over this rank's cache slots, combined over the
    model group with the other ranks' slots (the module's note, 2-3); the
    approximate attention at prefill over every rank's slots, gathered
    (the module's note).  Returns this rank's ``cols`` columns of the
    output (B, S, cols), the ones its block of ``wo`` multiplies."""
    b, s, h, hd = q.shape
    lo = ax.index * cols
    if cfg.attn_impl == "pallas" and not decode and _approx_attn(cfg) is not None:
        # the key block is part of the function: attend over the whole cache
        k, v, k_pos = (sharding.all_gather(t, ax, 1) for t in (k, v, k_pos))
        if cols % hd == 0 and (h * hd) % cols == 0:  # this rank's heads alone
            hl = cols // hd
            kv_lo, kv_hi = _kv_heads(ax.index, hl, h // k.shape[2])
            with sharding.heads_split(ax):
                out = _pallas(q[:, :, lo // hd:lo // hd + hl], k[:, :, kv_lo:kv_hi],
                              v[:, :, kv_lo:kv_hi], q_pos, k_pos, decode=False, cfg=cfg, **kw)
            return out.reshape(b, s, cols)
        out = _pallas(q, k, v, q_pos, k_pos, decode=False, cfg=cfg, **kw)
    else:
        if cfg.attn_impl == "pallas" and decode:
            o, lse = flash_decode(q[:, 0], k, v, q_pos[:, -1], k_pos, window=kw["window"],
                                  softcap=kw["softcap"], scale=kw["scale"], with_lse=True)
            o, lse = o[:, None], lse[:, :, None]
        elif cfg.attn_impl == "pallas":
            o, lse = flash_attention_fwd(q, k, v, q_pos, k_pos, with_lse=True, **kw)
        else:
            o, lse = attend(q, k, v, q_pos, k_pos, decode=decode, with_lse=True, **kw)
        out = combine_over(o, lse, ax)
    return out.reshape(b, s, h * hd)[:, :, lo:lo + cols]


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
    ax = (sharding.model_axis()
          if sharding.tp_role(getattr(params["wq"], "spec", None)) == "column" else None)

    q = layers.dense(x, params["wq"], ctx, "attn")
    k = layers.dense(x, params["wk"], ctx, "attn")
    v = layers.dense(x, params["wv"], ctx, "attn")
    q_norm, k_norm = params.get("q_norm_scale"), params.get("k_norm_scale")
    if ax is not None:
        q, k, v, q_whole, whole = _split_heads(q, k, v, ax, h, kvh, hd)
        if cfg.use_qk_norm and q_norm is not None:  # this rank's heads add a part of the grad
            q_norm = sharding.copy_to(sharding.use(q_norm), ax)
            k_norm = sharding.copy_to(sharding.use(k_norm), ax)
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.use_qk_norm and q_norm is not None:
        q = layers.rms_norm(q, q_norm, cfg.norm_eps)
        k = layers.rms_norm(k, k_norm, cfg.norm_eps)
    if cfg.use_mrope:
        q = layers.mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = layers.mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        positions = positions[0]  # masks, pad offsets and kernels read the t-ids
    else:
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)

    decode = s == 1 and cache is not None
    window = cfg.local_window if local else None
    kw = dict(causal=causal, window=window, softcap=cfg.attn_logit_softcap, scale=hd**-0.5)
    base, total = 0, None
    if ax is not None and cache is not None:
        # the hand-over to the sequence-split cache (the module's note, 1)
        if not q_whole:
            q = sharding.all_gather(q, ax, 2)
        if not whole:
            k, v = sharding.all_gather(k, ax, 2), sharding.all_gather(v, ax, 2)
        q_whole = True
        base, total = ax.index * cache.k.shape[1], cache.k.shape[1] * ax.size
    elif ax is not None and whole and not q_whole:  # the KV heads its query heads read
        lo, hi = _kv_heads(ax.index, q.shape[2], h // kvh)
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]

    if cache is not None:
        t = cache.k.shape[1]
        per_row = torch.is_tensor(cache_pos) and cache_pos.ndim >= 1
        if per_row:
            starts = cache_pos.to(torch.int64)
        else:
            starts = torch.full((b,), int(cache_pos), dtype=torch.int64, device=x.device)
        if total is None:
            _write_rows(cache.k, k, starts)
            _write_rows(cache.v, v, starts)
        else:
            _write_range(cache.k, k, starts, base, total)
            _write_range(cache.v, v, starts, base, total)
        k, v = cache.k, cache.v
        jj = base + torch.arange(t, device=x.device)[None, :].expand(b, t)
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

    if total is not None:
        out = _ranges_attention(q, k, v, q_pos, k_pos, decode=decode, cfg=cfg, ax=ax,
                                cols=params["wo"].shape[0], **kw)
        q_whole = False  # this rank's columns already
    elif cfg.attn_impl == "pallas":
        with sharding.heads_split(None if ax is None or q_whole else ax):
            out = _pallas(q, k, v, q_pos, k_pos, decode=decode, cfg=cfg, **kw)
    else:
        out = attend(q, k, v, q_pos, k_pos, decode=decode, **kw)
    out = out.reshape(b, s, -1)
    if ax is not None and q_whole:  # the columns this rank's block of wo multiplies
        c = params["wo"].shape[0]
        out = out[:, :, ax.index * c:(ax.index + 1) * c]
    out = out.to(x.dtype)
    return layers.dense(out, params["wo"], ctx, "attn"), cache
