"""Encoder-decoder backbone (the Seamless-M4T family).

Counterpart of ``repro/models/encdec.py``.  The encoder is a stack of
non-causal self-attention blocks over precomputed frame embeddings (the
modality frontend is a stub: inputs arrive as (B, S_src, d_model)), then
``enc_final_norm``.  Each decoder block runs causal self-attention with
its KV cache, cross-attention over the encoder memory, then the gated
MLP.  At serving the cross K/V of every layer are computed once from the
memory (:meth:`EncoderDecoder.precompute_cross`) and carried in the
decoder's caches; in training they are computed from the memory inside
each block.

Cross-attention is plain torch on every ``attn_impl``, as in the
reference (``_cross_attend`` calls ``attention._attend_direct``): the
query positions are zero and only ``mem_pos`` masks, so no kernel runs
there.  The encoder's self-attention goes through ``models.attention``
with ``causal=False``, so under ``attn_impl="pallas"`` it reaches
``flash_attention`` (or ``approx_flash_attention``) non-causal.  Every
projection, the cross ones included, goes through the engine under the
``"attn"`` and ``"mlp"`` targets.

**Tensor parallelism** (placed parameters, ``distributed.sharding``).  The
encoder's and the decoder's self-attention and MLPs are column- and
row-parallel as the decoder-only stack's (``models/attention.py``,
``models/layers.py``), the token table vocab-parallel.  ``cross_wq``,
``cross_wk`` and ``cross_wv`` are column-parallel and ``cross_wo``
row-parallel (the reference constrains q to ``(DP, None, TP, None)`` and
the output to ``(DP, None, TP)``).  Without a cache (training) each rank
attends with its query heads over the KV heads they read, as the
self-attention does.  The cross K/V cache (B, S_mem, KV, hd) is placed by
the reference's 4-d cache rule ``(DP, TP, None, None)``: each rank holds
memory slots ``[r S_mem / m, (r + 1) S_mem / m)`` of every KV head.  So a
step with a cache gathers q over heads, attends with every head over its
own slots (plain torch, with lse), and the ranks' (o, lse) are combined in
rank order (``kernels.flash_attention.combine_ranges``, as the
self-attention's decode over a sequence-split cache); each rank keeps its
heads' columns for ``cross_wo``.

The reference scans stacked layers; here each stack is an
``nn.ModuleList`` run in a loop, and the decoder caches are a list of
:class:`DecCache`, one per layer, whose self KV cache is written in place.
``cfg.remat`` applies per block as in ``models.transformer``; a block
draws its noise from (seed, layer) with the encoder's layers numbered
first, then the decoder's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.kernels.flash_attention import _attend_direct
from repro_torch.models import attention, layers
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Transformer, _remat, embed_lookup

__all__ = ["DecBlock", "DecCache", "EncBlock", "EncoderDecoder", "init_dec_caches"]


class DecCache(NamedTuple):
    self_kv: KVCache  # (B, S_max, KV, hd), the causal self-attention cache
    cross_k: torch.Tensor  # (B, S_mem, KV, hd), fixed after precompute
    cross_v: torch.Tensor


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


def init_enc_block(cfg: ModelConfig, dtype, device, generator) -> dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return {"ln1": zeros(), "attn": attention.init_attn(cfg, dtype, device, generator),
            "ln2": zeros(), "ffn": layers.init_mlp(cfg, dtype, device, generator)}


def init_dec_block(cfg: ModelConfig, dtype, device, generator) -> dict:
    d, hq, hkv = cfg.d_model, cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=device)
    dense = lambda d_in, d_out: layers.normal_init((d_in, d_out), d_in**-0.5, dtype, device,
                                                   generator)
    return {
        "ln1": zeros(),
        "attn": attention.init_attn(cfg, dtype, device, generator),
        "ln_cross": zeros(),
        "cross": {"cross_wq": dense(d, hq), "cross_wk": dense(d, hkv),
                  "cross_wv": dense(d, hkv), "cross_wo": dense(hq, d)},
        "ln2": zeros(),
        "ffn": layers.init_mlp(cfg, dtype, device, generator),
    }


class EncBlock(nn.Module):
    """Pre-norm non-causal self-attention, then the gated MLP."""

    def __init__(self, tensors: dict, index: int):
        super().__init__()
        self.index = index
        self.ln1, self.ln2 = nn.Parameter(tensors["ln1"]), nn.Parameter(tensors["ln2"])
        self.attn, self.ffn = _params(tensors["attn"]), _params(tensors["ffn"])

    def forward(self, x, src_pos, ctx: Ctx):
        ctx = ctx.for_block(self.index, x.device)
        cfg = ctx.cfg
        h = layers.rms_norm(x, self.ln1, cfg.norm_eps)
        out, _ = attention.attention(self.attn, h, src_pos, ctx, causal=False)
        x = x + out
        h2 = layers.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + layers.mlp(self.ffn, h2, ctx)


def _cross_axis(cross):
    """The model axis ``cross_wq``'s columns are split over, or None."""
    if sharding.tp_role(getattr(cross["cross_wq"], "spec", None)) == "column":
        return sharding.model_axis()
    return None


def _memory_kv(cross, memory, ctx: Ctx, *, cached: bool = False):
    """A layer's cross K/V (B, S_mem, KV, hd) from the memory (B, S_mem, D).
    Under a model axis they come out of the column-parallel products (this
    rank's KV heads, or whole: the module's note); ``cached``, as a cache
    holds them, every KV head over this rank's memory slots."""
    cfg = ctx.cfg
    b, sm, _ = memory.shape
    k = layers.dense(memory, cross["cross_wk"], ctx, "attn")
    v = layers.dense(memory, cross["cross_wv"], ctx, "attn")
    ax = _cross_axis(cross)
    if ax is not None and not cached:  # this rank's columns, as _cross_attend reads them
        return k, v
    if ax is not None:
        kv = cfg.num_kv_heads * cfg.head_dim
        k, v = ((t if t.shape[-1] == kv else sharding.gather(t, ax, -1)) for t in (k, v))
        k, v = (sharding.split(t, ax, 1) for t in (k, v))
    return k.reshape(b, k.shape[1], -1, cfg.head_dim), v.reshape(b, v.shape[1], -1,
                                                                  cfg.head_dim)


def _cross_attend(cross, x, mem_pos, ck, cv, ctx: Ctx, *, cached: bool = False) -> torch.Tensor:
    """Cross-attention of ``x`` (B, S, D) over the cross K/V: plain attention,
    query positions zero, only ``mem_pos`` masking (``-1`` slots).  Under a
    model axis, ``cached`` K/V are this rank's memory slots (the module's
    note); else this rank's KV heads as :func:`_memory_kv` gives them."""
    cfg = ctx.cfg
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = layers.dense(x, cross["cross_wq"], ctx, "attn")
    q_pos = torch.zeros((b, s), dtype=torch.int64, device=x.device)
    kw = dict(causal=False, window=None, softcap=None, scale=hd**-0.5)
    ax = _cross_axis(cross)
    q_whole = False
    if ax is None:
        out = _attend_direct(q.reshape(b, s, h, hd), ck, cv, q_pos, mem_pos, **kw)
    elif cached:  # every head over this rank's slots, combined over the ranks
        if q.shape[-1] != h * hd:
            q = sharding.all_gather(q, ax, -1)
        q_whole = True
        t = ck.shape[1]
        k_pos = mem_pos[:, ax.index * t:(ax.index + 1) * t]
        o, lse = _attend_direct(q.reshape(b, s, h, hd), ck, cv, q_pos, k_pos, with_lse=True,
                                **kw)
        out = attention.combine_over(o, lse, ax)
    else:  # this rank's query heads over the KV heads they read
        q, k, v, q_whole, whole = attention._split_heads(q, ck, cv, ax, h, kvh, hd)
        k, v = k.reshape(b, k.shape[1], -1, hd), v.reshape(b, v.shape[1], -1, hd)
        q = q.reshape(b, s, -1, hd)
        if whole and not q_whole:
            lo, hi = attention._kv_heads(ax.index, q.shape[2], h // kvh)
            k, v = k[:, :, lo:hi], v[:, :, lo:hi]
        out = _attend_direct(q, k, v, q_pos, mem_pos, **kw)
    out = out.reshape(b, s, -1)
    if q_whole:  # the columns this rank's block of cross_wo multiplies
        c = cross["cross_wo"].shape[0]
        out = out[:, :, ax.index * c:(ax.index + 1) * c]
    return layers.dense(out.to(x.dtype), cross["cross_wo"], ctx, "attn")


class DecBlock(nn.Module):
    """Pre-norm causal self-attention, cross-attention over the memory, the
    gated MLP."""

    def __init__(self, tensors: dict, index: int):
        super().__init__()
        self.index = index
        for name in ("ln1", "ln_cross", "ln2"):
            setattr(self, name, nn.Parameter(tensors[name]))
        for name in ("attn", "cross", "ffn"):
            setattr(self, name, _params(tensors[name]))

    def forward(self, x, positions, mem_pos, ctx: Ctx, memory, cache: Optional[DecCache],
                cache_pos):
        """Either ``memory`` (no cache: the cross K/V are computed here) or a
        cache holding them; returns (x, cache)."""
        ctx = ctx.for_block(self.index, x.device)
        cfg = ctx.cfg
        h = layers.rms_norm(x, self.ln1, cfg.norm_eps)
        skv = cache.self_kv if cache is not None else None
        out, _ = attention.attention(self.attn, h, positions, ctx, cache=skv,
                                     cache_pos=cache_pos)
        x = x + out
        hc = layers.rms_norm(x, self.ln_cross, cfg.norm_eps)
        ck, cv = (cache.cross_k, cache.cross_v) if cache is not None else _memory_kv(
            self.cross, memory, ctx)
        x = x + _cross_attend(self.cross, hc, mem_pos, ck, cv, ctx, cached=cache is not None)
        h2 = layers.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + layers.mlp(self.ffn, h2, ctx), cache


def init_dec_caches(cfg: ModelConfig, batch: int, max_seq: int, mem_len: int, dtype,
                    device, ax=None) -> list:
    """One zero :class:`DecCache` per decoder layer: the self KV cache and
    the cross K/V slots; with a model axis ``ax``, this rank's sequence
    shard of both (the module's note)."""
    m = 1 if ax is None else ax.size
    xkv = (batch, mem_len // m, cfg.num_kv_heads, cfg.head_dim)
    return [DecCache(attention.init_kv_cache(cfg, batch, max_seq // m, dtype, device),
                     torch.zeros(xkv, dtype=dtype, device=device),
                     torch.zeros(xkv, dtype=dtype, device=device))
            for _ in range(cfg.num_layers)]


class EncoderDecoder(nn.Module):
    """The token table (tied or with ``lm_head``), the encoder and decoder
    stacks and their final norms (the parameters)."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(tensors["embed"])
        self.enc_final_norm = nn.Parameter(tensors["enc_final_norm"])
        self.final_norm = nn.Parameter(tensors["final_norm"])
        self.lm_head_w = nn.Parameter(tensors["lm_head"]) if "lm_head" in tensors else None
        self.enc_layers = nn.ModuleList(EncBlock(t, i) for i, t in enumerate(tensors["enc"]))
        self.dec_layers = nn.ModuleList(DecBlock(t, cfg.encoder_layers + i)
                                        for i, t in enumerate(tensors["dec"]))

    @classmethod
    def init(cls, cfg: ModelConfig, *, seed: int, device: torch.device) -> "EncoderDecoder":
        """Seeded random weights with the scales of ``encdec.init_params``;
        shapes only on the ``meta`` device."""
        dtype = getattr(torch, cfg.dtype)
        gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
        zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)
        tensors = {
            "embed": layers.normal_init((cfg.vocab_size, cfg.d_model), cfg.d_model**-0.5,
                                        dtype, device, gen),
            "enc_final_norm": zeros(),
            "final_norm": zeros(),
            "enc": [init_enc_block(cfg, dtype, device, gen) for _ in range(cfg.encoder_layers)],
            "dec": [init_dec_block(cfg, dtype, device, gen) for _ in range(cfg.num_layers)],
        }
        if not cfg.tie_embeddings:
            tensors["lm_head"] = layers.normal_init(
                (cfg.d_model, cfg.vocab_size), cfg.d_model**-0.5, dtype, device, gen)
        return cls(cfg, tensors)

    def _remat(self, caches) -> str:
        return self.cfg.remat if caches is None and torch.is_grad_enabled() else "none"

    def encode(self, src_embeds: torch.Tensor, src_pos: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        """Frame embeddings (B, S_src, D) -> memory (B, S_src, D)."""
        cfg = self.cfg
        x = src_embeds.to(self.embed.dtype)
        remat = self._remat(None)
        for block in self.enc_layers:
            x = _remat(block, remat)(x, src_pos, ctx)
        return layers.rms_norm(x, self.enc_final_norm, cfg.norm_eps)

    def precompute_cross(self, memory: torch.Tensor, ctx: Ctx) -> list:
        """Each decoder layer's cross K/V (B, S_mem, KV, hd) from the memory."""
        return [_memory_kv(block.cross, memory, ctx, cached=True) for block in self.dec_layers]

    def decode_forward(self, tokens, positions, mem_pos, ctx: Ctx, *, memory=None,
                       caches: Optional[list] = None, cache_pos=None):
        """The decoder over ``tokens`` at ``positions``: either ``memory``
        (training: the cross K/V computed in each block) or ``caches`` with
        precomputed cross K/V.  Returns (hidden, caches)."""
        cfg = self.cfg
        x = embed_lookup(self.embed, tokens)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
        remat = self._remat(caches)
        for i, block in enumerate(self.dec_layers):
            cache = caches[i] if caches is not None else None
            x, _ = _remat(block, remat)(x, positions, mem_pos, ctx, memory, cache, cache_pos)
        return layers.rms_norm(x, self.final_norm, cfg.norm_eps), caches

    lm_head = Transformer.lm_head  # the decoder's head, as the decoder-only stack's
