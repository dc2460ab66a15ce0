"""Continuous-batching scheduler: slot-based admission, per-row retirement.

Counterpart of ``repro/serve/scheduler.py``.  A fixed pool of
``batch_size`` slots shares one KV cache of ``prompt_len + max_new``
entries per slot (plus the strategy's spare tail).  Admission runs a
single-row prefill of the new request (left-padded into the prompt
bucket, with true per-row positions so pads are masked out of the cache)
and writes that row's cache into the free slot; decode advances every live
row with per-row positions; a row retires the round it hits its budget or
EOS, and its slot is refilled before the next round.

:meth:`ContinuousScheduler.run` drives the pool in a closed loop (the
queue drains as fast as slots free) or an open loop (``arrivals_s``: a
request becomes admissible once the clock passes its arrival), with an
admission policy of :mod:`repro_torch.serve.policy` choosing admission and
the serving tier once per tick and a virtual (modeled) or wall clock.
``static_serve_loop`` is the static-batch loop, the baseline and oracle.

Decoder-only attention families (``supports_continuous``); data-parallel
meshes are ROADMAP.md's 'Modules to port' item 11.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.serve.policy import AdmissionPolicy, LoadSnapshot, StaticTier, get_policy
from repro_torch.serve.request import Request, RequestStats
from repro_torch.serve.stats import ServeResult, ServeStats, SlotAccounting
from repro_torch.serve.strategy import RowView, TierEngine, build_tier_engine, get_strategy
from repro_torch.train.steps import make_decode_step, make_prefill_step

__all__ = [
    "ContinuousScheduler",
    "continuous_serve_loop",
    "has_recurrent_state",
    "static_serve_loop",
    "supports_continuous",
]

RECURRENT_KINDS = ("rglru", "ssd")  # layer kinds with pad-absorbing state


def has_recurrent_state(cfg) -> bool:
    return any(k in RECURRENT_KINDS for k in cfg.layer_pattern)


def supports_continuous(cfg) -> bool:
    """Whether the continuous scheduler fully supports ``cfg``, padded
    admission of mixed-length prompts included: attention-only decoder
    stacks.  The scheduler's checks and the CLI's choice share it."""
    return not cfg.is_encdec and not has_recurrent_state(cfg)


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
    t_first: float  # clock at the first token (perf_counter in the closed loop)
    t_done: float = 0.0
    done: bool = False
    finish_reason: str = ""
    arrival_s: float = 0.0  # open loop: arrival time on the run clock
    queue_delay_s: Optional[float] = None  # open loop: admission - arrival
    tier_served: str = ""
    proposed: int = 0  # speculative: draft tokens proposed for this row
    accepted: int = 0  # speculative: of those, accepted by the verify forward

    @property
    def emitted(self) -> int:
        return len(self.tokens)

    def absorb(self, tok: int, now: Optional[float] = None) -> None:
        """Take one token; ``now`` stamps completion on the open-loop clock
        (the closed loop stamps perf_counter)."""
        self.tokens.append(tok)
        if self.req.eos_id is not None and tok == self.req.eos_id:
            self.done, self.finish_reason = True, "eos"
        elif self.emitted >= self.req.max_new:
            self.done, self.finish_reason = True, "budget"
        if self.done:
            self.t_done = time.perf_counter() if now is None else now


class ContinuousScheduler:
    """Slot-pool continuous-batching scheduler over one model + params.

    Args:
      model, params: a built decoder-only model and its parameters (a
        ``Transformer`` module; the pool runs on its device).
      batch_size: number of slots.
      prompt_len: prompt bucket width (every prompt is left-padded to it).
      max_new: per-slot generation capacity.
      quality: optional accuracy tier; the model is rebuilt on the tier's
        resolved engine config, and requests tagged with another tier are
        refused at admission (under tier-enforcing policies).
      strategy: a :mod:`repro_torch.serve.strategy` name (``"greedy"`` /
        ``"speculative"``) or a ``DecodeStrategy``; ``SelfSpeculative``
        reserves ``extra_capacity`` spare KV slots per row, admits at its
        verify tier and commits 1..k+1 verify-quality tokens per round.
    """

    def __init__(self, model, params, *, batch_size: int, prompt_len: int,
                 max_new: int, mesh=None, quality=None, strategy=None):
        if mesh is not None:
            raise NotImplementedError(
                "data-parallel serving is not ported yet (ROADMAP.md, 'Modules to port' "
                "item 11)"
            )
        if model.cfg.is_encdec:
            raise ValueError(
                "ContinuousScheduler supports decoder-only families; "
                "serve encoder-decoder configs with static_serve_loop"
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
        built on first visit and cached; strategies reach their draft and
        verify tiers through it."""
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
        """Run the pool prefill, an admission, a pool decode and the
        strategy's own steps once."""
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
            arrivals_s: Optional[Sequence[float]] = None, policy=None,
            step_time_s: float = 0.01, clock: str = "virtual") -> ServeResult:
        """Serve ``requests`` to completion; returns stats + token streams.

        **Closed loop** (``arrivals_s=None``): the queue is drained as fast
        as slots free up; times are seconds from the run's start.

        **Open loop** (``arrivals_s``: one non-decreasing arrival time per
        request, seconds from the run's start): a request is admissible once
        the clock passes its arrival; ``ttft_s`` / ``latency_s`` are taken
        from arrival and ``queue_delay_s`` is the wait.  ``clock="virtual"``
        advances the clock by ``step_time_s`` times the serving tier's
        ``tier_cycle_factor`` per admission prefill and decode step (a
        deterministic, model-independent schedule); ``"wall"`` is real
        time, idle gaps slept through.

        ``policy`` (an ``AdmissionPolicy`` or a name of ``POLICIES``) picks
        the serving tier once per tick, for admissions and decode alike,
        and decides per queued request whether to admit or shed it.
        """
        open_loop = arrivals_s is not None
        pol = get_policy(policy) if policy is not None else StaticTier()
        arrivals = None
        if open_loop:
            arrivals = [float(a) for a in arrivals_s]
            if len(arrivals) != len(requests):
                raise ValueError(
                    f"arrivals_s has {len(arrivals)} entries for {len(requests)} requests"
                )
            if any(b < a for a, b in zip(arrivals, arrivals[1:])):
                raise ValueError("arrivals_s must be non-decreasing")
            if step_time_s <= 0:
                raise ValueError(f"step_time_s must be > 0, got {step_time_s}")
            if clock not in ("virtual", "wall"):
                raise ValueError(f"clock must be 'virtual' or 'wall', got {clock!r}")
        if warmup:
            self.warmup()
        with torch.inference_mode():
            return self._run(requests, pol, arrivals, step_time_s, clock)

    def _run(self, requests: Sequence[Request], pol: AdmissionPolicy, arrivals,
             step_time_s: float, clock: str) -> ServeResult:
        open_loop = arrivals is not None
        virtual = clock == "virtual"
        B, P = self.batch_size, self.prompt_len
        pending: collections.deque = collections.deque(
            zip(requests, arrivals) if open_loop else ())
        queue: collections.deque = collections.deque(() if open_loop else requests)
        arrived_at: dict = {}  # id -> arrival time, while queued (open loop)
        slots: list[Optional[_Slot]] = [None] * B
        retired: list[RequestStats] = []
        rejected: list[RequestStats] = []
        outputs: dict = {}
        cur_tok = np.zeros((B, 1), np.int64)
        prefill_s = decode_s = 0.0
        step = 0
        busy_row_steps = 0
        # slot-accounting ledger (stats.SlotAccounting), counted as the loop runs
        seated_total = pool_seats = admission_seats = max_live = 0
        seat_counts = [0] * B
        last_write = [0] * B  # per-slot last physical KV write index
        position_violations = 0
        spec_rounds = spec_proposed = spec_accepted = 0
        modeled_cost = 0.0  # sum of round costs in exact-decode-step units
        engine = self._base_engine
        # admissions run at the strategy's admission tier: the serving engine
        # for greedy, the verify tier for a speculative strategy
        admit_eng = self.engine_for(self.strategy.admission_key(engine.key))
        pol.begin(self.quality)
        now = 0.0  # open-loop clock (virtual seconds, or wall since t0)
        t0 = time.perf_counter()

        def pump() -> None:
            # open loop: arrived requests move from the pending stream to the queue
            while pending and pending[0][1] <= now + 1e-12:
                req, arr = pending.popleft()
                arrived_at[req.id] = arr
                queue.append(req)

        def snapshot() -> LoadSnapshot:
            head_wait = now - arrived_at[queue[0].id] if open_loop and queue else 0.0
            return LoadSnapshot(
                now_s=now if open_loop else time.perf_counter() - t0, step=step,
                queue_depth=len(queue), pending=len(pending),
                live_rows=sum(1 for s in slots if s is not None), batch_size=B,
                head_wait_s=head_wait,
            )

        def retire(i: int) -> None:
            s = slots[i]
            if open_loop:  # what the client sees: both from arrival
                ttft = s.t_first - s.arrival_s
                latency = (s.t_done if s.done else now) - s.arrival_s
            else:
                ttft = s.t_first - t0
                latency = (s.t_done or time.perf_counter()) - t0
            rs = RequestStats(
                id=s.req.id, prompt_len=s.req.prompt_len, tokens_out=s.emitted,
                admit_step=s.admit_step, ttft_s=ttft, latency_s=latency,
                finish_reason=s.finish_reason,
                arrival_s=s.arrival_s if open_loop else 0.0,
                queue_delay_s=s.queue_delay_s, tier_served=s.tier_served,
                slo_ttft_s=s.req.slo_ttft_s, proposed=s.proposed, accepted=s.accepted,
            )
            retired.append(rs)
            outputs[s.req.id] = np.asarray(s.tokens, np.int32)
            slots[i] = None
            pol.observe(rs)

        def reject(req: Request) -> None:
            if open_loop:
                arr = arrived_at.pop(req.id)
                rs = RequestStats(
                    id=req.id, prompt_len=req.prompt_len, tokens_out=0, admit_step=step,
                    ttft_s=0.0, latency_s=now - arr, finish_reason="rejected",
                    arrival_s=arr, queue_delay_s=now - arr, slo_ttft_s=req.slo_ttft_s,
                )
            else:
                rs = RequestStats(
                    id=req.id, prompt_len=req.prompt_len, tokens_out=0, admit_step=step,
                    ttft_s=0.0, latency_s=time.perf_counter() - t0,
                    finish_reason="rejected", slo_ttft_s=req.slo_ttft_s,
                )
            rejected.append(rs)

        def seat(i: int, req: Request, tok0: int, t_first: float, *, pool: bool = False,
                 arrival: float = 0.0, queue_delay: Optional[float] = None) -> None:
            nonlocal seated_total, pool_seats, admission_seats
            seated_total += 1
            seat_counts[i] += 1
            if pool:
                pool_seats += 1
            else:
                admission_seats += 1
            last_write[i] = P - 1  # the prefill wrote slots [0, P)
            slot = _Slot(req=req, tokens=[], admit_step=step, t_first=t_first,
                         arrival_s=arrival, queue_delay_s=queue_delay,
                         tier_served=admit_eng.name or "")
            slot.absorb(tok0, now=t_first if open_loop else None)
            cur_tok[i, 0] = tok0
            slots[i] = slot
            if slot.done:  # budget 1 / instant EOS: free the slot again
                retire(i)

        if open_loop:
            if not virtual:
                now = time.perf_counter() - t0
            pump()
        if not open_loop and len(queue) >= B and type(pol).admit is AdmissionPolicy.admit:
            # initial fill: the batched prefill of all B slots is the pool cache
            # (only when the policy cannot shed: a shedding policy sees every
            # request through the per-request admission path)
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
            if open_loop:
                if not virtual:
                    now = time.perf_counter() - t0
                pump()
            # one control tick: the policy picks the tick's serving tier
            want = pol.tier(snapshot())
            want = want if want is not None else self.quality
            if want != engine.key:
                engine = self.engine_for(want)
                admit_eng = self.engine_for(self.strategy.admission_key(engine.key))
            # retire finished rows, refill freed slots from the queue
            for i in range(B):
                if slots[i] is not None and slots[i].done:
                    retire(i)
                while slots[i] is None and queue:
                    # the policy sees the queue with the head still in it
                    req = queue[0]
                    admit = pol.admit(req, snapshot())
                    queue.popleft()
                    if not admit:
                        reject(req)
                        continue
                    if pol.enforces_tier_tags:
                        _check_request_quality(req, self.quality)
                    t_a = time.perf_counter()
                    caches, tok0 = self._prefill_row(req, caches, i, admit_eng)
                    t_b = time.perf_counter()
                    prefill_s += t_b - t_a
                    if open_loop:
                        arr = arrived_at.pop(req.id)
                        qd = now - arr
                        now = (now + step_time_s * admit_eng.cost_factor if virtual
                               else time.perf_counter() - t0)
                        seat(i, req, tok0, now, arrival=arr, queue_delay=qd)
                        pump()  # admission took time: new arrivals?
                    else:
                        seat(i, req, tok0, t_b)
            live = [i for i in range(B) if slots[i] is not None]
            if not live:
                if open_loop and pending:
                    # idle: nothing decoding, nothing admissible; jump (or
                    # sleep) the clock to the next arrival
                    nxt_arrival = pending[0][1]
                    if virtual:
                        now = max(now, nxt_arrival)
                    else:
                        wait = nxt_arrival - (time.perf_counter() - t0)
                        if wait > 0:
                            time.sleep(wait)
                        now = time.perf_counter() - t0
                    pump()
                    continue
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
            spec_proposed += rr.proposed
            spec_accepted += rr.accepted
            if rr.proposed:
                spec_rounds += 1
            if open_loop:
                now = now + step_time_s * rr.cost if virtual else time.perf_counter() - t0
            for i in live:
                s = slots[i]
                pr = rr.per_row.get(i)
                if pr is not None:
                    s.proposed += pr[0]
                    s.accepted += pr[1]
                for tok in rr.tokens.get(i, ()):
                    if s.done:  # budget/EOS cut the committed run short
                        break
                    # per committed token: the physical write index advances
                    # by exactly one slot, stays in the logical window, and
                    # the true position is the write index shifted by the
                    # row's pad offset
                    wr = P + s.emitted - 1
                    pp = s.req.prompt_len + s.emitted - 1
                    if (
                        wr != last_write[i] + 1
                        or wr >= P + self.max_new
                        or pp != wr - (P - s.req.prompt_len)
                    ):
                        position_violations += 1
                    last_write[i] = wr
                    s.absorb(int(tok), now=now if open_loop else None)
                cur_tok[i, 0] = s.tokens[-1]
            if open_loop:
                pump()

        wall = time.perf_counter() - t0
        # SLO attainment over every offered request with an SLO: rejected
        # and starved requests count as missed
        slo_total = sum(1 for r in requests if r.slo_ttft_s is not None)
        slo_attained = sum(
            1 for r in retired if r.slo_ttft_s is not None and r.ttft_s <= r.slo_ttft_s
        )
        switches = pol.switches
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
            open_loop=open_loop,
            policy=pol.name,
            queue_delay_s=tuple(r.queue_delay_s for r in retired
                                if r.queue_delay_s is not None),
            tier_switches=len(switches),
            rejected=len(rejected),
            starved=len(requests) - len(retired) - len(rejected),
            slo_total=slo_total,
            slo_attained=slo_attained,
            strategy=self.strategy.name,
            spec_rounds=spec_rounds,
            spec_proposed=spec_proposed,
            spec_accepted=spec_accepted,
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
                           accounting=accounting, tier_switches=switches,
                           rejected=tuple(rejected))


def continuous_serve_loop(model, params, requests: Sequence[Request], *, batch_size: int,
                          prompt_len: int, max_new: int, mesh=None, warmup: bool = True,
                          quality=None, strategy=None, **run_kwargs) -> ServeResult:
    """One-shot convenience wrapper over :class:`ContinuousScheduler`;
    ``run_kwargs`` (``arrivals_s`` / ``policy`` / ``step_time_s`` /
    ``clock``) pass through to :meth:`ContinuousScheduler.run`."""
    sched = ContinuousScheduler(
        model, params, batch_size=batch_size, prompt_len=prompt_len, max_new=max_new,
        mesh=mesh, quality=quality, strategy=strategy,
    )
    return sched.run(requests, warmup=warmup, **run_kwargs)


# -------------------------------------------------------------------- static
def static_serve_loop(model, params, requests: Sequence[Request], *, batch_size: int,
                      prompt_len: int, gen: int, seed: int = 0, warmup: bool = True,
                      quality=None) -> ServeResult:
    """The static-batch loop, kept as baseline and oracle.

    Pops ``batch_size`` requests at a time, left-pads prompts into the
    shared bucket (every row shares the ``arange`` positions, the legacy
    position approximation), decodes each batch to the largest budget in
    it and re-batches only once the whole batch drains.  Finished rows burn
    dead decode steps until then; ``tokens_out`` counts the useful
    (budget/EOS-bounded) tokens only.  ``quality`` resolves a tier as the
    continuous scheduler does.  ``seed`` seeds the reference's encoder
    memory, which waits for the encoder-decoder family.
    """
    model, pool_tier = _apply_pool_quality(model, quality)
    cfg = model.cfg
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the static loop's encoder memory is not ported yet (ROADMAP.md, "
            f"'Modules to port' item 10e)"
        )
    prefill = make_prefill_step(model, prompt_len + gen)
    decode = make_decode_step(model)
    device = params.embed.device

    def make_batch(batch_reqs: list) -> dict:
        toks = np.zeros((len(batch_reqs), prompt_len), np.int64)
        for i, r in enumerate(batch_reqs):
            _check_request_quality(r, pool_tier)
            if r.prompt_len > prompt_len:
                raise ValueError(
                    f"request {r.id}: prompt length {r.prompt_len} exceeds bucket {prompt_len}"
                )
            if r.max_new > gen:
                raise ValueError(f"request {r.id}: budget {r.max_new} exceeds gen {gen}")
            toks[i, prompt_len - r.prompt_len:] = r.tokens
        return {"tokens": torch.as_tensor(toks, device=device)}

    with torch.inference_mode():
        if warmup and requests:
            # every batch shape the loop will see: the full batch and the remainder
            shapes = {min(batch_size, len(requests))}
            if len(requests) > batch_size and len(requests) % batch_size:
                shapes.add(len(requests) % batch_size)
            for b0 in sorted(shapes):
                dummy = [Request(id=-1, tokens=np.zeros(1, np.int32), max_new=1)] * b0
                caches, logits = prefill(params, make_batch(dummy))
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                decode(params, caches, tok, prompt_len)[0].cpu()

        queue = collections.deque(requests)
        retired: list[RequestStats] = []
        outputs: dict = {}
        prefill_s = decode_s = 0.0
        batch_latencies: list[float] = []
        total_steps = busy_row_steps = total_row_steps = max_live = 0

        t0 = time.perf_counter()
        while queue:
            t_batch = time.perf_counter()
            batch_reqs = [queue.popleft() for _ in range(min(batch_size, len(queue)))]
            max_live = max(max_live, len(batch_reqs))
            caches, logits = prefill(params, make_batch(batch_reqs))
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            tok.cpu()
            t_first = time.perf_counter()
            prefill_s += t_first - t_batch
            # the tokens stay on the device until the batch drains: one copy a batch
            step_toks = [tok]
            steps = min(gen, max(r.max_new for r in batch_reqs))
            for g in range(steps - 1):
                logits, caches = decode(params, caches, tok, prompt_len + g)
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                step_toks.append(tok)
            host_toks = torch.cat(step_toks, 1).cpu().numpy()
            decode_s += time.perf_counter() - t_first
            total_steps += steps - 1
            t_end = time.perf_counter()
            batch_latencies.append(t_end - t_batch)
            for r, stream in zip(batch_reqs, host_toks.tolist()):
                useful, reason = [], "budget"
                for t in stream[: r.max_new]:
                    useful.append(t)
                    if r.eos_id is not None and t == r.eos_id:
                        reason = "eos"
                        break
                # row r is live at decode step g iff it still needs token g+1:
                # steps past its useful length are the static batch's dead steps
                busy_row_steps += len(useful) - 1
                total_row_steps += steps - 1
                retired.append(RequestStats(
                    id=r.id, prompt_len=r.prompt_len, tokens_out=len(useful), admit_step=0,
                    ttft_s=t_first - t0, latency_s=t_end - t0, finish_reason=reason,
                ))
                outputs[r.id] = np.asarray(useful, np.int32)

    wall = time.perf_counter() - t0
    stats = ServeStats(
        requests=len(retired),
        tokens_out=sum(r.tokens_out for r in retired),
        wall_s=wall,
        prefill_s=prefill_s,
        decode_s=decode_s,
        batch_latencies_s=tuple(batch_latencies),
        devices=torch.cuda.device_count() if device.type == "cuda" else 1,
        scheduler="static",
        decode_steps=total_steps,
        slot_utilization=busy_row_steps / total_row_steps if total_row_steps else 1.0,
        ttft_s=tuple(r.ttft_s for r in retired),
        request_latencies_s=tuple(r.latency_s for r in retired),
        quality=pool_tier or "",
    )
    # no slot pool: every request is seated by its batch prefill and retired
    # when the batch drains, so the ledger balances by construction
    accounting = SlotAccounting(
        seated=len(retired),
        retired=len(retired),
        pool_prefill_seats=len(retired),
        admission_seats=0,
        max_live=max_live,
        slot_reuse=(),
        position_violations=0,
    )
    return ServeResult(stats=stats, request_stats=tuple(retired), outputs=outputs,
                       accounting=accounting)
