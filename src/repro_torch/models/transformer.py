"""Decoder-only stack: attention, RG-LRU and SSD blocks, dense or MoE feed-forwards.

Counterpart of ``repro/models/transformer.py``.  The reference scans
stacked layer groups with ``lax.scan``; here the layers are an
``nn.ModuleList`` run in a Python loop, and the caches are a list with
one cache per layer, by its kind: a
:class:`~repro_torch.models.attention.KVCache` for ``attn_global`` /
``attn_local``, an :class:`~repro_torch.models.rglru.RGLRUCache` for
``rglru`` (recurrentgemma's Griffin blocks) and an
:class:`~repro_torch.models.ssd.SSDCache` for ``ssd`` (mamba2).
The encoder-decoder stack is ``models/encdec.py``.  A
block's feed-forward is the gated MLP (``ffn``) or, in an MoE model, the
routed experts (``ffn_moe``, ``models/moe.py``), whose load-balance loss
each block returns; an ``ssd`` block has one only when ``d_ff > 0``, as
in the reference.

``forward`` takes tokens, or precomputed embeddings (``embeds``, the
stubbed vision frontend's patch embeddings) in their place, and returns
the final hidden states, the caches and the blocks' aux loss summed in
layer order; ``lm_head`` turns the hidden states into logits.

Tensor parallelism (placed parameters, ``distributed.sharding``): the
embedding is vocab-parallel (its rows split over the model axis, as the
reference's ``(TP, FSDP)`` rule places it): each rank looks up the tokens
its rows hold, zeros elsewhere, and an all-reduce adds the ranks' rows,
which is exact (every element is one rank's value plus zeros).  The head,
tied or not, is column-parallel over the vocabulary; ``lm_head`` gathers
the logits over the model group for the serving steps, and the train loss
streams this rank's vocabulary slice (``train/losses.py``).

**Sequence-sharded residuals** (``cfg.seq_shard_residuals``, placed
parameters, a model axis that divides the sequence): the residual stream
between blocks is this rank's (B, S / m, d) slice, as the reference
constrains it to ``(DP, TP, None)``, so remat saves a slice.  Each block
gathers its normed input's sequence before the mixer and the
feed-forward (``sharding.all_gather_keep``: every rank then carries the
whole gradient, and keeps its slice of it; the norms' scales, applied to
this rank's tokens, have their gradients added over the model group),
and each row-parallel output
is summed by a reduce-scatter over the sequence in place of the model
all-reduce (``sharding.seq_parallel``, ``sharding.row_output``); an output
that arrives whole (a replicated layer, an engine's row sums) is split.
The embedding's output is split after the lookup, and the last block's
output gathered before the final norm.

The parameters are trainable ``nn.Parameter`` s; serving runs under
``torch.inference_mode()`` so that no step records a graph.  ``cfg.remat``
maps the reference's remat policies (applied there to the scanned group
body) onto ``torch.utils.checkpoint`` per block when gradients are on and
no cache is written: ``"full"`` saves only the block's input and
recomputes the block in the backward, ``"dots"`` saves the outputs of the
2-D matrix products (the reference's ``checkpoint_dots_with_no_batch_dims``)
and recomputes the rest, ``"none"`` saves everything.  A recomputed block
draws the same noise as its first pass: under a training seed each block
makes its generator anew from (seed, layer) whenever it runs
(``Ctx.for_block``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as _checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import attention, layers, moe, rglru, ssd
from repro_torch.models.layers import Ctx

__all__ = ["Block", "Transformer", "block_kinds", "embed_lookup", "has_recurrent_state",
           "head_matrix", "init_cache"]

_ATTN_KINDS = ("attn_global", "attn_local")
_RECURRENT_KINDS = ("rglru", "ssd")  # block kinds with a recurrent state, which takes in pads


def block_kinds(cfg: ModelConfig) -> list[str]:
    pat = cfg.layer_pattern
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def has_recurrent_state(cfg: ModelConfig) -> bool:
    return any(k in _RECURRENT_KINDS for k in cfg.layer_pattern)


def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    if kind == "ssd":
        return cfg.d_ff > 0
    return cfg.d_ff > 0 or cfg.num_experts > 0


def init_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, dtype, device, ax=None):
    """A zero cache for one layer of ``kind``; with a model axis ``ax``,
    this rank's shard of it (``launch/specs.py``'s rule: the KV cache's
    sequence, the SSD state's heads, the channels of a conv tail and of the
    RG-LRU state)."""
    if kind in _ATTN_KINDS:
        seq = max_seq if ax is None else max_seq // ax.size
        return attention.init_kv_cache(cfg, batch, seq, dtype, device)
    if kind == "rglru":
        return rglru.init_rglru_cache(cfg, batch, dtype, device, ax)
    if kind == "ssd":
        return ssd.init_ssd_cache(cfg, batch, dtype, device, ax)
    raise ValueError(f"unknown block kind {kind!r}")


def _vocab_axis(table: torch.Tensor, vocab_dim: int):
    """The model axis a placed table's vocabulary dimension is split over, or None."""
    spec = getattr(table, "spec", None)
    if spec and sharding.TP in sharding.spec_axes(spec[vocab_dim]):
        return sharding.model_axis()
    return None


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``; vocab-parallel where ``embed`` is placed so (the
    module's note)."""
    ax = _vocab_axis(embed, 0)
    w = sharding.use(embed)
    if ax is None:
        return w[tokens]
    lo = ax.index * w.shape[0]
    loc = tokens - lo
    mine = (loc >= 0) & (loc < w.shape[0])
    rows = w[torch.where(mine, loc, 0)]
    return sharding.reduce_from(torch.where(mine[..., None], rows, 0.0).to(w.dtype), ax)


def head_matrix(params, cfg: ModelConfig):
    """``(w (D, V_local), axis)``: the head matrix as the loss and the logits
    use it, and the model axis its vocabulary is split over (None: whole)."""
    if cfg.tie_embeddings:
        return sharding.use(params.embed).T, _vocab_axis(params.embed, 0)
    return sharding.use(params.lm_head_w), _vocab_axis(params.lm_head_w, 1)


# the reference's checkpoint_dots_with_no_batch_dims: 2-D products, not batched ones
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    policy = _checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` under the config's remat policy (see the module's note)."""
    if remat == "none":
        return fn
    if remat == "dots":
        context = functools.partial(_checkpoint.create_selective_checkpoint_contexts,
                                    _dots_policy)
        return functools.partial(_checkpoint.checkpoint, fn, use_reentrant=False,
                                 context_fn=context)
    if remat == "full":
        return functools.partial(_checkpoint.checkpoint, fn, use_reentrant=False)
    raise ValueError(f"unknown remat policy {remat!r}; expected none, dots or full")


_MIXERS = ("attn", "rglru", "ssd")


class Block(nn.Module):
    """One pre-norm decoder block: its mixer (attention, RG-LRU or SSD), then
    the gated MLP or the routed experts, where the block has one."""

    def __init__(self, cfg: ModelConfig, kind: str, tensors: dict, index: int):
        super().__init__()
        self.kind = kind
        self.index = index
        self.ln1 = nn.Parameter(tensors["ln1"])
        for name in ("post_ln1", "ln2", "post_ln2"):
            if name in tensors:
                setattr(self, name, nn.Parameter(tensors[name]))
        for name in _MIXERS + ("ffn", "ffn_moe"):
            setattr(self, name, nn.ParameterDict(
                {k: nn.Parameter(v) for k, v in tensors[name].items()})
                if name in tensors else None)

    def forward(self, x, positions, ctx: Ctx, cache, cache_pos, sp=None):
        """Returns (x, cache, aux): aux is the MoE load-balance loss, float32
        0-d, or None without experts.  ``sp`` is the model axis the
        residual's sequence is split over (the module's note), or None."""
        ctx = ctx.for_block(self.index, x.device)
        cfg = ctx.cfg
        def norm(v, scale):  # over this rank's tokens: its part of the scale's gradient
            return layers.rms_norm(v, sharding.copy_to(sharding.use(scale), sp), cfg.norm_eps)

        with sharding.seq_parallel(sp):
            h = sharding.all_gather_keep(norm(x, self.ln1), sp, 1)
            if self.kind == "rglru":
                out, new_cache = rglru.rglru_block(self.rglru, h, ctx, cache=cache)
            elif self.kind == "ssd":
                out, new_cache = ssd.ssd_block(self.ssd, h, ctx, cache=cache)
            else:
                out, new_cache = attention.attention(
                    self.attn, h, positions, ctx,
                    local=(self.kind == "attn_local"), cache=cache, cache_pos=cache_pos,
                )
            out = _seq_slice(out, x, sp)
            if cfg.use_post_norm:
                out = norm(out, self.post_ln1)
            x = x + out
            aux = None
            if self.ffn is not None or self.ffn_moe is not None:
                h2 = sharding.all_gather_keep(norm(x, self.ln2), sp, 1)
                if self.ffn_moe is not None:
                    out2, aux = moe.moe_ffn(self.ffn_moe, h2, ctx)
                else:
                    out2 = layers.mlp(self.ffn, h2, ctx)
                out2 = _seq_slice(out2, x, sp)
                if cfg.use_post_norm:
                    out2 = norm(out2, self.post_ln2)
                x = x + out2
        return x, new_cache, aux


def _seq_slice(out: torch.Tensor, x: torch.Tensor, sp) -> torch.Tensor:
    """A block part's output as the residual ``x`` holds it: already this
    rank's sequence slice (reduce-scattered), or split from the whole."""
    return out if sp is None or out.shape[1] == x.shape[1] else sharding.split(out, sp, 1)


def init_block_tensors(cfg: ModelConfig, kind: str, dtype, device, generator) -> dict:
    """Seeded tensors of one block of ``kind`` with the reference's scales
    and zero-init norms."""
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    p = {"ln1": zeros()}
    if kind in _ATTN_KINDS:
        p["attn"] = attention.init_attn(cfg, dtype, device, generator)
    elif kind == "rglru":
        p["rglru"] = rglru.init_rglru(cfg, dtype, device, generator)
    elif kind == "ssd":
        p["ssd"] = ssd.init_ssd(cfg, dtype, device, generator)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if cfg.use_post_norm:
        p["post_ln1"] = zeros()
    if _has_ffn(cfg, kind):
        p["ln2"] = zeros()
        if cfg.num_experts > 0:
            p["ffn_moe"] = moe.init_moe(cfg, dtype, device, generator)
        else:
            p["ffn"] = layers.init_mlp(cfg, dtype, device, generator)
        if cfg.use_post_norm:
            p["post_ln2"] = zeros()
    return p


class Transformer(nn.Module):
    """Embedding, the decoder blocks and the final norm (the parameters)."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(tensors["embed"])
        self.final_norm = nn.Parameter(tensors["final_norm"])
        self.lm_head_w = nn.Parameter(tensors["lm_head"]) if "lm_head" in tensors else None
        kinds = block_kinds(cfg)
        self.layers = nn.ModuleList(
            Block(cfg, kind, tensors["blocks"][i], i) for i, kind in enumerate(kinds)
        )

    @classmethod
    def init(cls, cfg: ModelConfig, *, seed: int, device: torch.device) -> "Transformer":
        """Seeded random weights with the scales of ``transformer.init_params``;
        shapes only on the ``meta`` device (the dry-run's stand-ins)."""
        dtype = getattr(torch, cfg.dtype)
        gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
        tensors = {
            "embed": layers.normal_init(
                (cfg.vocab_size, cfg.d_model), cfg.d_model**-0.5, dtype, device, gen
            ),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "blocks": [init_block_tensors(cfg, kind, dtype, device, gen)
                       for kind in block_kinds(cfg)],
        }
        if not cfg.tie_embeddings:
            tensors["lm_head"] = layers.normal_init(
                (cfg.d_model, cfg.vocab_size), cfg.d_model**-0.5, dtype, device, gen
            )
        return cls(cfg, tensors)

    def forward(self, tokens, positions, ctx: Ctx, *, embeds: Optional[torch.Tensor] = None,
                caches: Optional[list] = None, cache_pos=None):
        """Returns (hidden (B, S, D), caches, aux): ``embeds`` (B, S, D), when
        given, take the place of the token lookup; aux is the blocks' MoE
        load-balance losses summed in layer order (float32 0-d)."""
        cfg = self.cfg
        x = embed_lookup(self.embed, tokens) if embeds is None else embeds.to(self.embed.dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
        remat = cfg.remat if caches is None and torch.is_grad_enabled() else "none"
        sp = self._seq_axis(x.shape[1])
        x = sharding.split(x, sp, 1)
        aux = None
        for i, block in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            x, nc, a = _remat(block, remat)(x, positions, ctx, cache, cache_pos, sp)
            if a is not None:
                aux = a if aux is None else aux + a
            if caches is not None:
                caches[i] = nc
        x = sharding.all_gather_keep(x, sp, 1)
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, caches, aux

    def _seq_axis(self, seq: int):
        """The model axis the residual stream's sequence is split over
        (``cfg.seq_shard_residuals``, placed parameters, an axis that
        divides ``seq``), or None."""
        if not (self.cfg.seq_shard_residuals and sharding.is_placed(self)):
            return None
        ax = sharding.model_axis()
        return ax if ax is not None and seq % ax.size == 0 else None

    def lm_head(self, hidden: torch.Tensor) -> torch.Tensor:
        """Full logits (B, S, V) in f32 (gathered over the model group where
        the vocabulary is split; no gradient through the gather)."""
        cfg = self.cfg
        w, ax = head_matrix(self, cfg)
        logits = hidden.to(torch.float32) @ w.to(torch.float32)
        if cfg.final_logit_softcap:
            logits = torch.tanh(logits / cfg.final_logit_softcap) * cfg.final_logit_softcap
        return sharding.gather(logits, ax, -1)
