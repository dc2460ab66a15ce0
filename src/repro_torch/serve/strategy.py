"""Decode strategies: how a slot pool turns live rows into tokens.

Counterpart of ``repro/serve/strategy.py``: :class:`TierEngine` (one
accuracy tier's admit / pool-prefill / decode steps over the shared pool
cache, built by :func:`build_tier_engine`) and :class:`GreedyDecode` (one
pool decode per round, greedy argmax).  The reference jits its steps;
PyTorch runs them eagerly.  ``SelfSpeculative`` is not ported yet
(ROADMAP.md, 'Modules to port' item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.train.steps import make_decode_step, make_prefill_step

__all__ = [
    "TierEngine",
    "build_tier_engine",
    "RowView",
    "RoundResult",
    "DecodeStrategy",
    "GreedyDecode",
    "get_strategy",
]


@dataclasses.dataclass(frozen=True)
class TierEngine:
    """One accuracy tier's serving steps over the shared slot pool.

    Approximation changes only the forward math, not the cache shapes, so
    every engine reads and writes the same pool cache.
    """

    key: Optional[str]  # engine-cache key (canonical tier, None = pool base)
    name: Optional[str]  # canonical tier name (None = no tier applied)
    admit_step: object  # single-row prefill + scatter + argmax
    prefill_pool: object  # batched pool prefill + argmax
    decode: object  # pool decode with the greedy argmax
    cost_factor: float  # tier_cycle_factor: modeled cost per step


def build_tier_engine(model, capacity: int, *, name, key, scatter_row) -> TierEngine:
    """The (admit, pool-prefill, decode) bundle for one tier;
    ``scatter_row(big, small, row)`` writes a single-row cache into the pool.
    Each step runs under ``torch.inference_mode()``: the parameters are
    trainable, and a served step must record no autograd graph."""
    prefill = make_prefill_step(model, capacity)
    decode = make_decode_step(model)

    @torch.inference_mode()
    def admit_step(params, caches, toks, pos, row):
        row_caches, logits = prefill(params, {"tokens": toks, "positions": pos})
        caches = scatter_row(caches, row_caches, row)
        return caches, torch.argmax(logits[0, -1], -1)

    @torch.inference_mode()
    def prefill_pool(params, toks, pos):
        caches, logits = prefill(params, {"tokens": toks, "positions": pos})
        return caches, torch.argmax(logits[:, -1], -1)

    @torch.inference_mode()
    def decode_greedy(params, caches, tok, pos, write):
        logits, caches = decode(params, caches, tok, pos, write)
        return torch.argmax(logits[:, -1], -1), caches

    from repro_torch.engine.config import tier_cycle_factor

    return TierEngine(
        key=key, name=name, admit_step=admit_step, prefill_pool=prefill_pool,
        decode=decode_greedy, cost_factor=tier_cycle_factor(name),
    )


@dataclasses.dataclass(frozen=True)
class RowView:
    """What a strategy may know about one live row (a host-side snapshot)."""

    index: int  # slot index in the pool
    prompt_len: int  # true (unpadded) prompt length
    emitted: int  # tokens emitted so far (>= 1: admission token counted)
    strategy: Optional[str] = None  # per-request tag (None = pool default)


@dataclasses.dataclass(frozen=True)
class RoundResult:
    """One decode round's outcome: the committed tokens per row, the pool
    cache, the model forwards run and the modeled cost."""

    tokens: dict  # row index -> list[int]
    caches: object
    steps: int
    cost: float
    proposed: int = 0
    accepted: int = 0
    per_row: dict = dataclasses.field(default_factory=dict)


class DecodeStrategy:
    """Protocol: one decode round over the live rows of a slot pool."""

    name = "greedy"

    @property
    def extra_capacity(self) -> int:
        """Extra physical KV slots per row beyond ``prompt_len + max_new``."""
        return 0

    def admission_key(self, policy_key):
        """Engine key admissions run at (greedy: the serving tier)."""
        return policy_key

    def warmup(self, pool) -> None:
        """Run any strategy-specific steps once outside the timed region."""

    def decode_round(self, pool, engine, caches, cur_tok, rows,
                     *, speculate: bool = True) -> RoundResult:
        raise NotImplementedError


class GreedyDecode(DecodeStrategy):
    """One pool decode per round."""

    name = "greedy"

    def decode_round(self, pool, engine, caches, cur_tok, rows,
                     *, speculate: bool = True) -> RoundResult:
        B = cur_tok.shape[0]
        P = pool.prompt_len
        # per-row true position + physical write slot; dead lanes park at
        # the last physical slot with offset 0
        pos = np.full((B,), pool.capacity - 1, np.int64)
        write = np.full((B,), pool.capacity - 1, np.int64)
        for r in rows:
            pos[r.index] = r.prompt_len + r.emitted - 1
            write[r.index] = P + r.emitted - 1
        dev = pool.device
        nxt, caches = engine.decode(
            pool.params, caches, torch.as_tensor(cur_tok, device=dev),
            torch.as_tensor(pos, device=dev), torch.as_tensor(write, device=dev),
        )
        nxt = nxt.cpu().numpy()
        return RoundResult(
            tokens={r.index: [int(nxt[r.index])] for r in rows},
            caches=caches, steps=1, cost=engine.cost_factor,
        )


def get_strategy(strategy) -> DecodeStrategy:
    """Resolve a strategy name (or pass an instance through)."""
    if strategy is None or strategy == "greedy":
        return GreedyDecode()
    if isinstance(strategy, DecodeStrategy):
        return strategy
    if strategy == "speculative":
        raise NotImplementedError(
            "self-speculative decoding is not ported yet (ROADMAP.md, "
            "'Modules to port' item 7)"
        )
    raise ValueError(f"unknown decode strategy {strategy!r}; known: ['greedy']")
