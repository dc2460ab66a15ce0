"""Decoder-only transformer stack: attention blocks, dense or MoE feed-forwards.

Counterpart of ``repro/models/transformer.py``.  The reference scans
stacked layer groups with ``lax.scan``; here the layers are an
``nn.ModuleList`` run in a Python loop, and the caches are a list with
one :class:`~repro_torch.models.attention.KVCache` per layer.  Block
kinds other than ``attn_global`` / ``attn_local`` (RG-LRU, SSD) and
encoder-decoder models raise and name the slice that ports them.  A
block's feed-forward is the gated MLP (``ffn``) or, in an MoE model, the
routed experts (``ffn_moe``, ``models/moe.py``), whose load-balance loss
each block returns.

``forward`` takes tokens, or precomputed embeddings (``embeds``, the
stubbed vision frontend's patch embeddings) in their place, and returns
the final hidden states, the caches and the blocks' aux loss summed in
layer order; ``lm_head`` turns the hidden states into logits.

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
from repro_torch.models import attention, layers, moe
from repro_torch.models.layers import Ctx

__all__ = ["Block", "Transformer", "block_kinds", "check_supported"]

_ATTN_KINDS = ("attn_global", "attn_local")


def block_kinds(cfg: ModelConfig) -> list[str]:
    pat = cfg.layer_pattern
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet: RG-LRU and SSD blocks, and
    encoder-decoder models."""
    other = sorted({k for k in block_kinds(cfg) if k not in _ATTN_KINDS})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {other} are not ported yet "
            f"(ROADMAP.md, 'Modules to port' item 10)"
        )
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(ROADMAP.md, 'Modules to port' item 10)"
        )


def _has_ffn(cfg: ModelConfig) -> bool:
    return cfg.d_ff > 0 or cfg.num_experts > 0


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


class Block(nn.Module):
    """One pre-norm decoder block: attention, then the gated MLP or the
    routed experts."""

    def __init__(self, cfg: ModelConfig, kind: str, tensors: dict, index: int):
        super().__init__()
        self.kind = kind
        self.index = index
        self.ln1 = nn.Parameter(tensors["ln1"])
        self.attn = nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors["attn"].items()})
        for name in ("post_ln1", "ln2", "post_ln2"):
            if name in tensors:
                setattr(self, name, nn.Parameter(tensors[name]))
        for name in ("ffn", "ffn_moe"):
            setattr(self, name, nn.ParameterDict(
                {k: nn.Parameter(v) for k, v in tensors[name].items()})
                if name in tensors else None)

    def forward(self, x, positions, ctx: Ctx, cache, cache_pos):
        """Returns (x, cache, aux): aux is the MoE load-balance loss, float32
        0-d, or None without experts."""
        ctx = ctx.for_block(self.index, x.device)
        cfg = ctx.cfg
        h = layers.rms_norm(x, self.ln1, cfg.norm_eps)
        out, new_cache = attention.attention(
            self.attn, h, positions, ctx,
            local=(self.kind == "attn_local"), cache=cache, cache_pos=cache_pos,
        )
        if cfg.use_post_norm:
            out = layers.rms_norm(out, self.post_ln1, cfg.norm_eps)
        x = x + out
        aux = None
        if self.ffn is not None or self.ffn_moe is not None:
            h2 = layers.rms_norm(x, self.ln2, cfg.norm_eps)
            if self.ffn_moe is not None:
                out2, aux = moe.moe_ffn(self.ffn_moe, h2, ctx)
            else:
                out2 = layers.mlp(self.ffn, h2, ctx)
            if cfg.use_post_norm:
                out2 = layers.rms_norm(out2, self.post_ln2, cfg.norm_eps)
            x = x + out2
        return x, new_cache, aux


def init_block_tensors(cfg: ModelConfig, dtype, device, generator) -> dict:
    """Seeded block tensors with the reference's scales and zero-init norms."""
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    p = {"ln1": zeros(), "attn": attention.init_attn(cfg, dtype, device, generator)}
    if cfg.use_post_norm:
        p["post_ln1"] = zeros()
    if _has_ffn(cfg):
        d, f = cfg.d_model, cfg.d_ff
        p["ln2"] = zeros()
        if cfg.num_experts > 0:
            p["ffn_moe"] = moe.init_moe(cfg, dtype, device, generator)
        else:
            p["ffn"] = {
                "w1": layers.normal_init((d, f), d**-0.5, dtype, device, generator),
                "w3": layers.normal_init((d, f), d**-0.5, dtype, device, generator),
                "w2": layers.normal_init((f, d), f**-0.5, dtype, device, generator),
            }
        if cfg.use_post_norm:
            p["post_ln2"] = zeros()
    return p


class Transformer(nn.Module):
    """Embedding, the decoder blocks and the final norm (the parameters)."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        check_supported(cfg)
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
        """Seeded random weights with the scales of ``transformer.init_params``."""
        check_supported(cfg)
        dtype = getattr(torch, cfg.dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        tensors = {
            "embed": layers.normal_init(
                (cfg.vocab_size, cfg.d_model), cfg.d_model**-0.5, dtype, device, gen
            ),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "blocks": [init_block_tensors(cfg, dtype, device, gen) for _ in range(cfg.num_layers)],
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
        x = self.embed[tokens] if embeds is None else embeds.to(self.embed.dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
        remat = cfg.remat if caches is None and torch.is_grad_enabled() else "none"
        aux = None
        for i, block in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            x, nc, a = _remat(block, remat)(x, positions, ctx, cache, cache_pos)
            if a is not None:
                aux = a if aux is None else aux + a
            if caches is not None:
                caches[i] = nc
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, caches, aux

    def lm_head(self, hidden: torch.Tensor) -> torch.Tensor:
        """Full logits (B, S, V) in f32."""
        cfg = self.cfg
        w = self.embed.T if cfg.tie_embeddings else self.lm_head_w
        logits = hidden.to(torch.float32) @ w.to(torch.float32)
        if cfg.final_logit_softcap:
            logits = torch.tanh(logits / cfg.final_logit_softcap) * cfg.final_logit_softcap
        return logits
