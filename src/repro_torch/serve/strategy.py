"""Decode strategies: how a slot pool turns live rows into tokens.

Counterpart of ``repro/serve/strategy.py``: :class:`TierEngine` (one
accuracy tier's admit / pool-prefill / decode / verify steps over the
shared pool cache, built by :func:`build_tier_engine`),
:class:`GreedyDecode` (one pool decode per round, greedy argmax) and
:class:`SelfSpeculative` (``k`` draft-tier proposal steps and one batched
``(B, k+1)`` verify forward per round).  The reference jits its steps;
PyTorch runs them eagerly.

Every committed token of a speculative round is the verify engine's
greedy argmax.  Rollback is host-side bookkeeping: both phases write the
same physical KV slots (the verify forward overwrites every draft-quality
entry before its attention reads it), and a rejected suffix is rolled back
by not advancing the row's emitted count past it, so the next round writes
over the stale slots; key-position masking keeps them invisible meanwhile.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.models.transformer import has_recurrent_state
from repro_torch.train.steps import make_decode_step, make_prefill_step, mrope_positions

__all__ = [
    "TierEngine",
    "build_tier_engine",
    "make_verify_step",
    "RowView",
    "RoundResult",
    "DecodeStrategy",
    "GreedyDecode",
    "SelfSpeculative",
    "STRATEGIES",
    "get_strategy",
]


def make_verify_step(model):
    """verify(params, caches, tokens (B, S), positions (B, S), starts (B,))
    -> (argmax (B, S), caches).

    One multi-token forward over live caches: row ``i``'s ``S`` tokens sit
    at true positions ``positions[i]`` and write physical cache slots
    ``starts[i] .. starts[i] + S - 1``.  This is the speculative verify
    primitive: the prefill step builds fresh caches and the decode step
    takes one token.
    """

    def verify(params, caches, tokens, positions, starts):
        pos = mrope_positions(model.cfg, positions.to(torch.int64))
        hidden, caches, _ = model.forward(params, tokens, pos, model.ctx(), caches=caches,
                                          cache_pos=starts.to(torch.int64))
        return torch.argmax(model.lm_head(params, hidden), -1), caches

    return verify


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
    verify: object  # multi-token speculative verify forward
    cost_factor: float  # tier_cycle_factor: modeled cost per step


def build_tier_engine(model, capacity: int, *, name, key, scatter_row) -> TierEngine:
    """The (admit, pool-prefill, decode, verify) bundle for one tier;
    ``scatter_row(big, small, row)`` writes a single-row cache, every kind
    (KV, RG-LRU, SSD), into the pool.
    Each step runs under ``torch.inference_mode()``: the parameters are
    trainable, and a served step must record no autograd graph."""
    prefill = make_prefill_step(model, capacity)
    decode = make_decode_step(model)
    verify = torch.inference_mode()(make_verify_step(model))

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
        decode=decode_greedy, verify=verify, cost_factor=tier_cycle_factor(name),
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

    def check_config(self, cfg) -> None:
        """Raise if this strategy cannot serve ``cfg`` (greedy serves all)."""

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


class SelfSpeculative(DecodeStrategy):
    """k draft-tier proposal steps + one batched verify forward per round.

    Per live row with last committed token ``c`` at true position ``p0``
    (write slot ``w0``): the draft engine runs ``k`` chained single-token
    decodes proposing ``d_1 .. d_k``; the verify engine then runs one
    ``(B, k+1)`` forward over ``(c, d_1 .. d_k)`` at positions ``p0 ..
    p0+k`` writing slots ``w0 .. w0+k``.  The longest prefix where draft
    and verify agree is accepted, and the first disagreement contributes
    the verify token itself, so a round commits 1 to k+1 verify-quality
    tokens.

    ``verify_tier=None`` verifies at the tick's policy-selected engine; a
    ``verify_tier`` pins it.  A round speculates when some live row asked
    for it (``strategy="speculative"``) or no row carries a tag at all.
    """

    name = "speculative"

    def __init__(self, k: int = 4, draft_tier: str = "draft",
                 verify_tier: Optional[str] = None):
        if k < 1:
            raise ValueError(f"speculation depth k must be >= 1, got {k}")
        from repro_torch.engine.config import get_tier

        self.k = k
        self.draft_tier = get_tier(draft_tier).name
        self.verify_tier = get_tier(verify_tier).name if verify_tier is not None else None
        self._greedy = GreedyDecode()

    @property
    def extra_capacity(self) -> int:
        # the verify forward writes up to slot (prompt_len + max_new - 2) + k
        # for a row one token short of its budget; k spare slots cover it
        return self.k

    def admission_key(self, policy_key):
        return self.verify_tier if self.verify_tier is not None else policy_key

    def check_config(self, cfg) -> None:
        """Recurrent-state configs are refused: a verify forward writes k + 1
        steps into an RG-LRU or SSD state that no rollback can undo, and the
        reference's ``ssd_block`` even takes a carried cache as fresh at S > 1."""
        if has_recurrent_state(cfg):
            raise ValueError(
                f"{cfg.name}: self-speculative decoding cannot roll back recurrent "
                f"state; serve it greedy (ROADMAP.md, section 3, a reference fault "
                f"side-stepped)"
            )

    def wants_speculation(self, rows: Sequence[RowView]) -> bool:
        tags = [r.strategy for r in rows if r.strategy is not None]
        if not tags:
            return True  # untagged pool: the pool-level strategy rules
        return any(t == "speculative" for t in tags)

    def warmup(self, pool) -> None:
        """Run the draft decode and the verify forward once on throwaway caches."""
        B, dev = pool.batch_size, pool.device
        draft = pool.engine_for(self.draft_tier)
        verify = pool.engine_for(self.admission_key(pool.quality))
        caches = pool.init_pool_caches()
        zeros = torch.zeros((B,), dtype=torch.int64, device=dev)
        _, caches = draft.decode(pool.params, caches,
                                 torch.zeros((B, 1), dtype=torch.int64, device=dev), zeros, zeros)
        pos = torch.arange(self.k + 1, device=dev).expand(B, self.k + 1)
        ver, _ = verify.verify(pool.params, caches, torch.zeros_like(pos), pos, zeros)
        ver.cpu()

    def decode_round(self, pool, engine, caches, cur_tok, rows,
                     *, speculate: bool = True) -> RoundResult:
        verify_eng = pool.engine_for(self.verify_tier) if self.verify_tier is not None else engine
        if not speculate or not self.wants_speculation(rows):
            return self._greedy.decode_round(pool, verify_eng, caches, cur_tok, rows)
        draft_eng = pool.engine_for(self.draft_tier)
        B = cur_tok.shape[0]
        P, cap, k, dev = pool.prompt_len, pool.capacity, self.k, pool.device
        p0 = np.full((B,), cap - 1, np.int64)  # dead-lane park (offset 0)
        w0 = np.full((B,), cap - 1, np.int64)
        for r in rows:
            p0[r.index] = r.prompt_len + r.emitted - 1
            w0[r.index] = P + r.emitted - 1

        # draft phase: k chained cheap-tier decodes propose d_1..d_k; live rows
        # never clip (w0 + k < cap), the where only re-parks dead lanes
        first = torch.as_tensor(cur_tok, device=dev)  # never mutate the scheduler's array
        tok, props = first, []
        for j in range(k):
            pos = np.where(p0 + j < cap, p0 + j, cap - 1)
            wrt = np.where(w0 + j < cap, w0 + j, cap - 1)
            nxt, caches = draft_eng.decode(pool.params, caches, tok,
                                           torch.as_tensor(pos, device=dev),
                                           torch.as_tensor(wrt, device=dev))
            props.append(nxt)
            tok = nxt[:, None]

        # verify phase: one (B, k+1) forward on the verify engine, re-writing
        # slots w0..w0+k with verify-quality KV.  A dead lane parks its whole
        # window in the spare tail slots, causal at positions 0..k
        props = torch.stack(props, 1)
        starts = w0.copy()
        vpos = p0[:, None] + np.arange(k + 1, dtype=np.int64)[None, :]
        live = {r.index for r in rows}
        for i in range(B):
            if i not in live:
                starts[i] = cap - (k + 1)
                vpos[i] = np.arange(k + 1, dtype=np.int64)
        ver, caches = verify_eng.verify(pool.params, caches, torch.cat([first, props], 1),
                                        torch.as_tensor(vpos, device=dev),
                                        torch.as_tensor(starts, device=dev))
        both = torch.cat([props, ver], 1).cpu().numpy()  # one copy to the host a round
        props, ver = both[:, :k], both[:, k:]

        # accept: the longest agreeing prefix + the verify bonus token
        tokens: dict = {}
        per_row: dict = {}
        proposed = accepted = 0
        for r in rows:
            i = r.index
            a = 0
            while a < k and props[i, a] == ver[i, a]:
                a += 1
            tokens[i] = [int(t) for t in ver[i, : a + 1]]
            per_row[i] = (k, a)
            proposed += k
            accepted += a
        return RoundResult(
            tokens=tokens, caches=caches, steps=k + 1,
            cost=k * draft_eng.cost_factor + verify_eng.cost_factor,
            proposed=proposed, accepted=accepted, per_row=per_row,
        )


STRATEGIES = {
    "greedy": GreedyDecode,
    "speculative": SelfSpeculative,
}


def get_strategy(strategy, **kwargs) -> DecodeStrategy:
    """Resolve a strategy name (or pass an instance through) for the CLIs."""
    if strategy is None:
        strategy = "greedy"
    if isinstance(strategy, DecodeStrategy):
        if kwargs:
            raise ValueError("cannot pass strategy kwargs with an instance")
        return strategy
    try:
        cls = STRATEGIES[strategy]
    except KeyError:
        raise ValueError(
            f"unknown decode strategy {strategy!r}; known: {sorted(STRATEGIES)}"
        ) from None
    return cls(**kwargs)
