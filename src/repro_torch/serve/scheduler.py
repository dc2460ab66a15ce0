"""Continuous-batching scheduler: slot-based admission, per-row retirement.

Counterpart of ``repro/serve/scheduler.py`` in its closed loop.  A fixed
pool of ``batch_size`` slots shares one KV cache of ``prompt_len +
max_new`` entries per slot.  Admission runs a single-row prefill of the
new request (left-padded into the prompt bucket, with true per-row
positions so pads are masked out of the cache) and writes that row's
cache into the free slot; decode advances every live row one token with
per-row positions; a row retires the step it hits its budget or EOS, and
its slot is refilled before the next decode step.

Not ported yet, and raising with the ROADMAP item that ports them: the
open loop (``arrivals_s``) with its policies, self-speculative decoding,
data-parallel meshes and the static-batch loop.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.serve.policy import AdmissionPolicy, LoadSnapshot, StaticTier
from repro_torch.serve.request import Request, RequestStats
from repro_torch.serve.stats import ServeResult, ServeStats, SlotAccounting
from repro_torch.serve.strategy import RowView, TierEngine, build_tier_engine, get_strategy

__all__ = ["ContinuousScheduler", "continuous_serve_loop"]

_OPEN_LOOP = "ROADMAP.md, 'Modules to port' item 7 (open-loop admission and its policies)"


def _apply_pool_quality(model, quality):
    """Resolve an accuracy tier into this pool's engine config; returns
    ``(model, canonical_tier_name)``."""
    if quality is None:
        return model, None
    from repro_torch.engine import config as engine_config
    from repro_torch.models.registry import build_model

    tier = engine_config.get_tier(quality)
    return build_model(engine_config.apply_quality(model.cfg, tier)), tier.name


def _check_request_quality(req: Request, pool_tier) -> None:
    """A request sold at a tier must be served by a pool resolved to that
    tier; a mismatch raises at admission."""
    if req.quality is None:
        return
    from repro_torch.engine.config import get_tier

    want = get_tier(req.quality).name
    if pool_tier is None:
        raise ValueError(
            f"request {req.id} demands quality tier {want!r}, but this pool "
            f"was built without one (pass quality={want!r}, or run one pool "
            f"per tier)"
        )
    if want != pool_tier:
        raise ValueError(
            f"request {req.id} demands quality tier {want!r}, but this pool "
            f"serves {pool_tier!r}; run one pool per tier"
        )


def _scatter_row(big: list, small: list, row: int) -> list:
    """Write the single-row caches ``small`` into row ``row`` of ``big``,
    in place (the reference returns an updated copy)."""
    for b, s in zip(big, small):
        b.k[row] = s.k[0]
        b.v[row] = s.v[0]
    return big


@dataclasses.dataclass
class _Slot:
    """Host-side state of one live row."""

    req: Request
    tokens: list
    admit_step: int
    t_first: float
    t_done: float = 0.0
    done: bool = False
    finish_reason: str = ""
    tier_served: str = ""

    @property
    def emitted(self) -> int:
        return len(self.tokens)

    def absorb(self, tok: int) -> None:
        self.tokens.append(tok)
        if self.req.eos_id is not None and tok == self.req.eos_id:
            self.done, self.finish_reason = True, "eos"
        elif self.emitted >= self.req.max_new:
            self.done, self.finish_reason = True, "budget"
        if self.done:
            self.t_done = time.perf_counter()


class ContinuousScheduler:
    """Slot-pool continuous-batching scheduler over one model + params.

    Args:
      model, params: a built model and its parameters (a ``Transformer``
        module; the pool runs on its device).
      batch_size: number of slots.
      prompt_len: prompt bucket width (every prompt is left-padded to it).
      max_new: per-slot generation capacity.
      quality: optional accuracy tier; the model is rebuilt on the tier's
        resolved engine config, and requests tagged with another tier are
        refused at admission.
      strategy: ``"greedy"`` (or ``None``, or a ``DecodeStrategy``).
    """

    def __init__(self, model, params, *, batch_size: int, prompt_len: int,
                 max_new: int, mesh=None, quality=None, strategy=None):
        if mesh is not None:
            raise NotImplementedError(
                "data-parallel serving is not ported yet (ROADMAP.md, 'Modules to port' "
                "item 11)"
            )
        if batch_size < 1 or prompt_len < 1 or max_new < 1:
            raise ValueError("batch_size, prompt_len and max_new must be >= 1")
        model, self.quality = _apply_pool_quality(model, quality)
        self.model, self.params = model, params
        self.batch_size, self.prompt_len, self.max_new = batch_size, prompt_len, max_new
        self.strategy = get_strategy(strategy)
        self.capacity = prompt_len + max_new + self.strategy.extra_capacity
        self.device = params.embed.device
        self._cache_dtype = getattr(torch, model.cfg.dtype)
        self._engines: dict = {}
        self._base_engine = self.engine_for(self.quality)

    def engine_for(self, tier) -> TierEngine:
        """The engine serving ``tier`` (None = the pool's base config),
        built on first visit and cached."""
        key = tier if tier is not None else self.quality
        eng = self._engines.get(key)
        if eng is None:
            model, name = _apply_pool_quality(self.model, key)
            eng = build_tier_engine(
                model, self.capacity, name=name, key=key, scatter_row=_scatter_row,
            )
            self._engines[key] = eng
        return eng

    # ------------------------------------------------------------- helpers
    def _pad(self, req: Request) -> tuple:
        """Left-pad one prompt into the bucket; true position ids for pads < 0."""
        ln = req.prompt_len
        if ln > self.prompt_len:
            raise ValueError(
                f"request {req.id}: prompt length {ln} exceeds bucket {self.prompt_len}"
            )
        if req.max_new > self.max_new:
            raise ValueError(
                f"request {req.id}: budget {req.max_new} exceeds slot capacity {self.max_new}"
            )
        toks = np.zeros((self.prompt_len,), np.int64)
        toks[self.prompt_len - ln:] = req.tokens
        pos = np.arange(self.prompt_len, dtype=np.int64) - (self.prompt_len - ln)
        return toks, pos

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _prefill_row(self, req: Request, caches: list, row: int, engine: TierEngine):
        """Admission: single-row prefill + scatter; returns (caches, tok0)."""
        toks, pos = self._pad(req)
        caches, tok0 = engine.admit_step(
            self.params, caches, self._tensor(toks[None]), self._tensor(pos[None]), row
        )
        return caches, int(tok0.item())

    def warmup(self) -> None:
        """Run the pool prefill, an admission and a pool decode once."""
        B = self.batch_size
        eng = self._base_engine
        with torch.inference_mode():
            toks = np.zeros((B, self.prompt_len), np.int64)
            pos = np.tile(np.arange(self.prompt_len, dtype=np.int64), (B, 1))
            caches, _ = eng.prefill_pool(self.params, self._tensor(toks), self._tensor(pos))
            req = Request(id=-1, tokens=np.zeros(1, np.int32), max_new=1)
            caches, _ = self._prefill_row(req, caches, 0, eng)
            zeros = self._tensor(np.zeros((B,), np.int64))
            nxt, _ = eng.decode(self.params, caches, self._tensor(np.zeros((B, 1), np.int64)),
                                zeros, zeros)
            nxt.cpu()
            self.strategy.warmup(self)

    # ----------------------------------------------------------------- run
    def run(self, requests: Sequence[Request], *, warmup: bool = True,
            arrivals_s: Optional[Sequence[float]] = None, policy=None) -> ServeResult:
        """Serve ``requests`` to completion in the closed loop (the queue is
        drained as fast as slots free up); returns stats + token streams."""
        if arrivals_s is not None:
            raise NotImplementedError(f"open-loop admission is not ported yet ({_OPEN_LOOP})")
        if policy is None or policy == "static":
            pol = StaticTier()
        elif isinstance(policy, AdmissionPolicy):
            pol = policy
        else:
            raise NotImplementedError(f"policy {policy!r} is not ported yet ({_OPEN_LOOP})")
        if warmup:
            self.warmup()
        with torch.inference_mode():
            return self._run(requests, pol)

    def _run(self, requests: Sequence[Request], pol: AdmissionPolicy) -> ServeResult:
        B, P = self.batch_size, self.prompt_len
        queue: collections.deque = collections.deque(requests)
        slots: list[Optional[_Slot]] = [None] * B
        retired: list[RequestStats] = []
        rejected: list[RequestStats] = []
        outputs: dict = {}
        cur_tok = np.zeros((B, 1), np.int64)
        prefill_s = decode_s = 0.0
        step = 0
        busy_row_steps = 0
        seated_total = pool_seats = admission_seats = max_live = 0
        seat_counts = [0] * B
        last_write = [0] * B  # per-slot last physical KV write index
        position_violations = 0
        modeled_cost = 0.0
        engine = self._base_engine
        admit_eng = self.engine_for(self.strategy.admission_key(engine.key))
        pol.begin(self.quality)
        t0 = time.perf_counter()

        def snapshot() -> LoadSnapshot:
            return LoadSnapshot(
                now_s=time.perf_counter() - t0, step=step, queue_depth=len(queue), pending=0,
                live_rows=sum(1 for s in slots if s is not None), batch_size=B,
            )

        def retire(i: int) -> None:
            s = slots[i]
            rs = RequestStats(
                id=s.req.id, prompt_len=s.req.prompt_len, tokens_out=s.emitted,
                admit_step=s.admit_step, ttft_s=s.t_first - t0,
                latency_s=(s.t_done or time.perf_counter()) - t0,
                finish_reason=s.finish_reason, tier_served=s.tier_served,
                slo_ttft_s=s.req.slo_ttft_s,
            )
            retired.append(rs)
            outputs[s.req.id] = np.asarray(s.tokens, np.int32)
            slots[i] = None
            pol.observe(rs)

        def reject(req: Request) -> None:
            rejected.append(RequestStats(
                id=req.id, prompt_len=req.prompt_len, tokens_out=0, admit_step=step,
                ttft_s=0.0, latency_s=time.perf_counter() - t0, finish_reason="rejected",
                slo_ttft_s=req.slo_ttft_s,
            ))

        def seat(i: int, req: Request, tok0: int, t_first: float, *, pool: bool = False):
            nonlocal seated_total, pool_seats, admission_seats
            seated_total += 1
            seat_counts[i] += 1
            if pool:
                pool_seats += 1
            else:
                admission_seats += 1
            last_write[i] = P - 1  # the prefill wrote slots [0, P)
            slot = _Slot(req=req, tokens=[], admit_step=step, t_first=t_first,
                         tier_served=admit_eng.name or "")
            slot.absorb(tok0)
            cur_tok[i, 0] = tok0
            slots[i] = slot
            if slot.done:  # budget 1 / instant EOS: free the slot again
                retire(i)

        if len(queue) >= B and type(pol).admit is AdmissionPolicy.admit:
            # initial fill: the batched prefill of all B slots is the pool cache
            first = [queue.popleft() for _ in range(B)]
            if pol.enforces_tier_tags:
                for r in first:
                    _check_request_quality(r, self.quality)
            padded = [self._pad(r) for r in first]
            toks = self._tensor(np.stack([t for t, _ in padded]))
            pos = self._tensor(np.stack([p for _, p in padded]))
            caches, tok0s = admit_eng.prefill_pool(self.params, toks, pos)
            tok0s = tok0s.cpu().numpy()
            t_b = time.perf_counter()
            prefill_s += t_b - t0
            for i, req in enumerate(first):
                seat(i, req, int(tok0s[i]), t_b, pool=True)
        else:
            caches = self.model.init_caches(B, self.capacity, self._cache_dtype, self.device)
        while True:
            want = pol.tier(snapshot())
            want = want if want is not None else self.quality
            if want != engine.key:
                engine = self.engine_for(want)
                admit_eng = self.engine_for(self.strategy.admission_key(engine.key))
            for i in range(B):
                if slots[i] is not None and slots[i].done:
                    retire(i)
                while slots[i] is None and queue:
                    req = queue.popleft()
                    if not pol.admit(req, snapshot()):
                        reject(req)
                        continue
                    if pol.enforces_tier_tags:
                        _check_request_quality(req, self.quality)
                    t_a = time.perf_counter()
                    caches, tok0 = self._prefill_row(req, caches, i, admit_eng)
                    t_b = time.perf_counter()
                    prefill_s += t_b - t_a
                    seat(i, req, tok0, t_b)
            live = [i for i in range(B) if slots[i] is not None]
            if not live:
                break
            max_live = max(max_live, len(live))
            rows = [
                RowView(index=i, prompt_len=slots[i].req.prompt_len,
                        emitted=slots[i].emitted, strategy=slots[i].req.strategy)
                for i in live
            ]
            t_d = time.perf_counter()
            rr = self.strategy.decode_round(
                self, engine, caches, cur_tok, rows, speculate=pol.speculation(snapshot())
            )
            caches = rr.caches
            decode_s += time.perf_counter() - t_d
            step += rr.steps
            busy_row_steps += len(live) * rr.steps
            modeled_cost += rr.cost
            for i in live:
                s = slots[i]
                for tok in rr.tokens.get(i, ()):
                    if s.done:
                        break
                    # the physical write index advances by exactly one slot,
                    # stays in the logical window, and the true position is
                    # the write index shifted by the row's pad offset
                    wr = P + s.emitted - 1
                    pp = s.req.prompt_len + s.emitted - 1
                    if (
                        wr != last_write[i] + 1
                        or wr >= P + self.max_new
                        or pp != wr - (P - s.req.prompt_len)
                    ):
                        position_violations += 1
                    last_write[i] = wr
                    s.absorb(int(tok))
                cur_tok[i, 0] = s.tokens[-1]

        wall = time.perf_counter() - t0
        slo_total = sum(1 for r in requests if r.slo_ttft_s is not None)
        slo_attained = sum(
            1 for r in retired if r.slo_ttft_s is not None and r.ttft_s <= r.slo_ttft_s
        )
        devices = torch.cuda.device_count() if self.device.type == "cuda" else 1
        stats = ServeStats(
            requests=len(retired),
            tokens_out=sum(r.tokens_out for r in retired),
            wall_s=wall,
            prefill_s=prefill_s,
            decode_s=decode_s,
            batch_latencies_s=(),
            devices=devices,
            scheduler="continuous",
            decode_steps=step,
            slot_utilization=busy_row_steps / (B * step) if step else 1.0,
            ttft_s=tuple(r.ttft_s for r in retired),
            request_latencies_s=tuple(r.latency_s for r in retired),
            quality=self.quality or "",
            policy=pol.name,
            rejected=len(rejected),
            starved=len(requests) - len(retired) - len(rejected),
            slo_total=slo_total,
            slo_attained=slo_attained,
            strategy=self.strategy.name,
            modeled_cost=modeled_cost,
        )
        accounting = SlotAccounting(
            seated=seated_total,
            retired=len(retired),
            pool_prefill_seats=pool_seats,
            admission_seats=admission_seats,
            max_live=max_live,
            slot_reuse=tuple(seat_counts),
            position_violations=position_violations,
        )
        return ServeResult(stats=stats, request_stats=tuple(retired), outputs=outputs,
                           accounting=accounting, rejected=tuple(rejected))


def continuous_serve_loop(model, params, requests: Sequence[Request], *, batch_size: int,
                          prompt_len: int, max_new: int, warmup: bool = True, quality=None,
                          strategy=None, **run_kwargs) -> ServeResult:
    """One-shot convenience wrapper over :class:`ContinuousScheduler`."""
    sched = ContinuousScheduler(
        model, params, batch_size=batch_size, prompt_len=prompt_len, max_new=max_new,
        quality=quality, strategy=strategy,
    )
    return sched.run(requests, warmup=warmup, **run_kwargs)
