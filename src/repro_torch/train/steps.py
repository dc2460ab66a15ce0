"""Serving step factories: prefill and decode.

Counterpart of the serving pair in ``repro/train/steps.py``.  Prefill
builds fresh caches and writes positions [0, S) (or, given per-row true
positions of left-padded prompts, masks the pads out of the cache);
decode consumes one token per row at a scalar or per-row position.  The
reference jits these; PyTorch runs them eagerly.
"""

from __future__ import annotations

import torch

from repro_torch.models.registry import Model

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(model: Model, max_seq: int):
    """prefill(params, batch) -> (caches, last_token_logits (B, 1, V)).

    ``batch["positions"]`` (optional, (B, S)) gives per-row true position
    ids; pad slots carry negative ids and are masked out of the cache.
    """
    cfg = model.cfg
    cache_dtype = getattr(torch, cfg.dtype)

    def prefill(params, batch: dict):
        tokens = batch["tokens"]
        b, s = tokens.shape
        ctx = model.ctx()
        caches = model.init_caches(b, max_seq, cache_dtype, tokens.device)
        if "positions" in batch:
            pos = batch["positions"].to(torch.int64)
            cache_pos = torch.zeros((b,), dtype=torch.int64, device=tokens.device)
        else:
            pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
            cache_pos = 0
        hidden, caches = model.forward(params, tokens, pos, ctx, caches=caches,
                                       cache_pos=cache_pos)
        return caches, model.lm_head(params, hidden[:, -1:, :])

    return prefill


def make_decode_step(model: Model):
    """decode(params, caches, token (B,1), pos, write_pos=None) -> (logits, caches).

    ``pos`` is a scalar (every row at the same position, which is also the
    write slot) or a per-row (B,) tensor of true positions, with
    ``write_pos`` (default ``pos``) each row's physical write slot.
    """

    def decode(params, caches, token: torch.Tensor, pos, write_pos=None):
        b = token.shape[0]
        ctx = model.ctx()
        if torch.is_tensor(pos) and pos.ndim >= 1:
            pos = pos.to(torch.int64)
            p = pos[:, None]
            cache_pos = pos if write_pos is None else write_pos.to(torch.int64)
        else:
            p = torch.full((b, 1), int(pos), dtype=torch.int64, device=token.device)
            cache_pos = int(pos)
        hidden, caches = model.forward(params, token, p, ctx, caches=caches,
                                       cache_pos=cache_pos)
        return model.lm_head(params, hidden), caches

    return decode
