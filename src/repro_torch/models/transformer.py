"""Decoder-only transformer stack (dense attention blocks).

Counterpart of ``repro/models/transformer.py``.  The reference scans
stacked layer groups with ``lax.scan``; here the layers are an
``nn.ModuleList`` run in a Python loop, and the caches are a list with
one :class:`~repro_torch.models.attention.KVCache` per layer.  Block
kinds other than ``attn_global`` / ``attn_local`` (RG-LRU, SSD) and MoE
feed-forwards raise and name the slice that ports them.

``forward`` returns the final hidden states; ``lm_head`` turns them into
logits.

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
from repro_torch.models import attention, layers
from repro_torch.models.layers import Ctx

__all__ = ["Block", "Transformer", "block_kinds", "check_supported"]

_ATTN_KINDS = ("attn_global", "attn_local")


def block_kinds(cfg: ModelConfig) -> list[str]:
    pat = cfg.layer_pattern
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    other = sorted({k for k in block_kinds(cfg) if k not in _ATTN_KINDS})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {other} are not ported yet "
            f"(ROADMAP.md, 'Modules to port' item 10)"
        )
    if cfg.num_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: MoE feed-forwards are not ported yet "
            f"(ROADMAP.md, 'Modules to port' item 10)"
        )
    if cfg.is_encdec or cfg.use_mrope or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder, M-RoPE and frontend models are not "
            f"ported yet (ROADMAP.md, 'Modules to port' item 10)"
        )


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
    """One pre-norm decoder block: attention, then the gated MLP."""

    def __init__(self, cfg: ModelConfig, kind: str, tensors: dict, index: int):
        super().__init__()
        self.kind = kind
        self.index = index
        self.ln1 = nn.Parameter(tensors["ln1"])
        self.attn = nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors["attn"].items()})
        for name in ("post_ln1", "ln2", "post_ln2"):
            if name in tensors:
                setattr(self, name, nn.Parameter(tensors[name]))
        self.ffn = (
            nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors["ffn"].items()})
            if "ffn" in tensors else None
        )

    def forward(self, x, positions, ctx: Ctx, cache, cache_pos):
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
        if self.ffn is not None:
            out2 = layers.mlp(self.ffn, layers.rms_norm(x, self.ln2, cfg.norm_eps), ctx)
            if cfg.use_post_norm:
                out2 = layers.rms_norm(out2, self.post_ln2, cfg.norm_eps)
            x = x + out2
        return x, new_cache


def init_block_tensors(cfg: ModelConfig, dtype, device, generator) -> dict:
    """Seeded block tensors with the reference's scales and zero-init norms."""
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    p = {"ln1": zeros(), "attn": attention.init_attn(cfg, dtype, device, generator)}
    if cfg.use_post_norm:
        p["post_ln1"] = zeros()
    if cfg.d_ff > 0:
        d, f = cfg.d_model, cfg.d_ff
        p["ln2"] = zeros()
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

    def forward(self, tokens, positions, ctx: Ctx, *, caches: Optional[list] = None,
                cache_pos=None):
        """Returns (hidden (B, S, D), caches); dense blocks have no aux loss."""
        cfg = self.cfg
        x = self.embed[tokens]
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
        remat = cfg.remat if caches is None and torch.is_grad_enabled() else "none"
        for i, block in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            x, nc = _remat(block, remat)(x, positions, ctx, cache, cache_pos)
            if caches is not None:
                caches[i] = nc
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        return x, caches

    def lm_head(self, hidden: torch.Tensor) -> torch.Tensor:
        """Full logits (B, S, V) in f32."""
        cfg = self.cfg
        w = self.embed.T if cfg.tie_embeddings else self.lm_head_w
        logits = hidden.to(torch.float32) @ w.to(torch.float32)
        if cfg.final_logit_softcap:
            logits = torch.tanh(logits / cfg.final_logit_softcap) * cfg.final_logit_softcap
        return logits
