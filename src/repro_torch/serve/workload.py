"""Traffic-realistic workload generation: arrivals, length tails, tier mixes.

A copy of ``repro/serve/workload.py``.

Every serve number before this module came from a ~10-request uniform
draw (``synth_requests``), which makes the ROADMAP's "heavy traffic"
claims unfalsifiable: uniform mixes never exercise bursty admission
churn, long-tail prompt skew, or abusive clients.  This module is the
seeded generator the soak harness (``repro_torch.serve.soak``), the
``serve_soak`` benchmark suite, and the parameterized test sweep all
share — one spec + one seed fully determine the request trace
(:func:`trace_digest` pins that down byte for byte).

The knobs, each a small named model rather than a magic constant:

* **Arrival process** — ``immediate`` (closed-loop, everything queued at
  t=0: the legacy behavior), ``poisson`` (open-loop steady traffic at
  ``rate_rps``), or ``bursty`` (a 2-state Markov-modulated Poisson
  process: an *on* state arriving ``burst_factor`` times faster than the
  off state, occupied ``burst_fraction`` of the time — the classic model
  for flash-crowd traffic).
* **Length distributions** — per prompt length and generation budget:
  ``fixed`` (upper bound), ``min`` (lower bound), ``uniform``, ``zipf``
  (bounded power-law: mostly short with a heavy long tail), or
  ``lognormal`` (the shape real prompt-length histograms take).
* **Tier mix** — weighted assignment of ``Request.quality`` tags, so a
  soak can drive mixed sold-at-tier traffic through a pool (untagged
  requests ride any pool; tagged ones must match it).
* **Speculative fraction** — fraction of requests tagged
  ``Request.strategy == "speculative"``, drawn from a separate seeded
  stream so it never perturbs the other draws.  On a speculative pool
  this exercises mid-stream strategy switching (the churn and bursty
  presets tag a quarter of their traffic).
* **Abuse presets** — ``flood`` (every request pins the prompt bucket
  and the full generation budget: worst-case KV residency) and ``churn``
  (near-minimal budgets at high rate: most admissions retire
  immediately, maximizing slot-recycling pressure — and with
  ``eos_probe`` the soak harness stamps the pool's modal greedy first
  token as the trace's ``eos_id``, so the longer-budget tail retires by
  *true instant EOS*, not just budget exhaustion).

Requests are drawn lazily (:func:`iter_requests` / :func:`iter_windows`)
so a 100k-request soak never materializes the whole trace.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Iterator, Optional

import numpy as np

from repro_torch.serve.request import Request

__all__ = [
    "ARRIVALS",
    "LENGTH_DISTS",
    "PRESETS",
    "Workload",
    "WorkloadSpec",
    "generate",
    "iter_requests",
    "iter_windows",
    "preset_spec",
    "tier_mix_label",
    "trace_digest",
]

ARRIVALS = ("immediate", "poisson", "bursty")
LENGTH_DISTS = ("fixed", "min", "uniform", "zipf", "lognormal")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Everything that determines a workload besides the seed."""

    requests: int
    prompt_len: int  # upper prompt-length bound == the scheduler's bucket
    max_new: int  # upper generation-budget bound == the slot capacity
    vocab_size: int
    name: str = "custom"
    arrival: str = "poisson"
    rate_rps: float = 64.0  # long-run mean arrival rate (poisson + bursty)
    burst_factor: float = 8.0  # bursty: on-state rate multiplier (>= 1)
    burst_fraction: float = 0.15  # bursty: long-run fraction of time on
    mean_dwell_s: float = 0.25  # bursty: mean off-state dwell time
    prompt_dist: str = "zipf"
    gen_dist: str = "lognormal"
    min_prompt: int = 1
    min_gen: int = 1
    zipf_a: float = 1.8  # bounded-zipf exponent (> 1)
    lognormal_sigma: float = 0.8
    tier_mix: tuple = ()  # ((tier_name_or_None, weight), ...); () = untagged
    eos_id: Optional[int] = None
    # per-request TTFT SLO (seconds) stamped on every generated request;
    # None = no SLO.  The open-loop scheduler scores attainment against
    # it (repro_torch.serve.policy drives tier degradation from the same
    # target).
    slo_ttft_s: Optional[float] = None
    # ask the soak harness to *probe* the pool's modal greedy first token
    # and use it as the trace's eos_id (repro_torch.serve.soak.probe_eos_id) —
    # turns the churn preset's budget-capped retirement into true
    # instant-EOS retirement without hardcoding a weight-dependent token.
    eos_probe: bool = False
    # fraction of requests tagged ``strategy="speculative"`` (the rest
    # stay untagged).  On a speculative pool this drives mid-stream
    # strategy switching: rounds speculate only while some live row
    # carries the tag.  Drawn from a *separate* seeded stream, so
    # enabling it never perturbs the main-stream draws (arrivals,
    # lengths, budgets, tokens, tiers) — committed traces stay
    # byte-identical.
    spec_fraction: float = 0.0

    def __post_init__(self):
        if self.requests < 1:
            raise ValueError(f"requests must be >= 1, got {self.requests}")
        if self.arrival not in ARRIVALS:
            raise ValueError(f"arrival must be one of {ARRIVALS}, got {self.arrival!r}")
        for label, dist in (("prompt_dist", self.prompt_dist), ("gen_dist", self.gen_dist)):
            if dist not in LENGTH_DISTS:
                raise ValueError(f"{label} must be one of {LENGTH_DISTS}, got {dist!r}")
        if not 1 <= self.min_prompt <= self.prompt_len:
            raise ValueError(
                f"need 1 <= min_prompt <= prompt_len, got {self.min_prompt}/{self.prompt_len}"
            )
        if not 1 <= self.min_gen <= self.max_new:
            raise ValueError(f"need 1 <= min_gen <= max_new, got {self.min_gen}/{self.max_new}")
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.burst_factor < 1.0:
            raise ValueError(f"burst_factor must be >= 1, got {self.burst_factor}")
        if not 0.0 < self.burst_fraction < 1.0:
            raise ValueError(f"burst_fraction must be in (0, 1), got {self.burst_fraction}")
        if self.zipf_a <= 1.0:
            raise ValueError(f"zipf_a must be > 1, got {self.zipf_a}")
        for tier, weight in self.tier_mix:
            if tier is not None and not isinstance(tier, str):
                raise ValueError(f"tier_mix names must be str or None, got {tier!r}")
            if not weight > 0:
                raise ValueError(f"tier_mix weight for {tier!r} must be > 0, got {weight}")
        if self.slo_ttft_s is not None and self.slo_ttft_s <= 0:
            raise ValueError(f"slo_ttft_s must be > 0, got {self.slo_ttft_s}")
        if not 0.0 <= self.spec_fraction <= 1.0:
            raise ValueError(
                f"spec_fraction must be in [0, 1], got {self.spec_fraction}"
            )


# Named traffic shapes: overrides applied on top of the caller's sizes.
PRESETS: dict[str, dict] = {
    # open-loop steady state: memoryless arrivals, uniform lengths
    "steady": {"arrival": "poisson", "prompt_dist": "uniform", "gen_dist": "uniform"},
    # flash crowds over long-tail lengths — the realistic stress mix
    "bursty": {"arrival": "bursty", "prompt_dist": "zipf", "gen_dist": "lognormal",
               "spec_fraction": 0.25},
    # abusive client: every request pins the bucket and the full budget
    "flood": {"arrival": "immediate", "prompt_dist": "fixed", "gen_dist": "fixed"},
    # abusive client: near-minimal budgets at high rate — most admissions
    # retire on the spot, maximizing slot-recycling churn.  Budgets are
    # zipf from 1 (mostly 1, short tail above it) and eos_probe asks the
    # soak harness to stamp the pool's modal greedy first token as the
    # trace's eos_id, so the tail rows retire by *true instant EOS*
    # rather than budget exhaustion — real abusive-client behavior, not
    # just its deterministic stand-in.
    "churn": {"arrival": "poisson", "rate_rps": 256.0, "prompt_dist": "zipf",
              "gen_dist": "zipf", "min_gen": 1, "eos_probe": True,
              "spec_fraction": 0.25},
}


def preset_spec(
    name: str,
    *,
    requests: int,
    prompt_len: int,
    max_new: int,
    vocab_size: int,
    tier_mix: tuple = (),
    eos_id: Optional[int] = None,
    **overrides,
) -> WorkloadSpec:
    """A :class:`WorkloadSpec` from a named traffic preset (see PRESETS)."""
    if name not in PRESETS:
        raise ValueError(f"unknown workload preset {name!r}; known: {sorted(PRESETS)}")
    kw: dict = dict(PRESETS[name])
    kw.update(overrides)
    return WorkloadSpec(
        name=name, requests=requests, prompt_len=prompt_len, max_new=max_new,
        vocab_size=vocab_size, tier_mix=tuple(tier_mix), eos_id=eos_id, **kw,
    )


def tier_mix_label(tier_mix: tuple) -> str:
    """Stable row-key label for a tier mix, e.g. ``"balanced:3+none:1"``."""
    if not tier_mix:
        return "none"
    return "+".join(f"{t or 'none'}:{w:g}" for t, w in tier_mix)


class _Arrivals:
    """Stateful arrival clock: absolute seconds per request, in order."""

    def __init__(self, spec: WorkloadSpec, rng: np.random.Generator):
        self.spec, self.rng = spec, rng
        self.t = 0.0
        if spec.arrival == "bursty":
            f, bf = spec.burst_fraction, spec.burst_factor
            # split the long-run mean rate over the two states:
            #   (1-f) * rate_off + f * rate_off * bf == rate_rps
            self.rate_off = spec.rate_rps / ((1.0 - f) + f * bf)
            self.rate_on = self.rate_off * bf
            # dwell times chosen so the on-state long-run occupancy is f
            self.dwell_off = spec.mean_dwell_s
            self.dwell_on = spec.mean_dwell_s * f / (1.0 - f)
            self.on = False
            self.t_switch = float(rng.exponential(self.dwell_off))

    def next(self) -> float:
        spec = self.spec
        if spec.arrival == "immediate":
            return 0.0
        if spec.arrival == "poisson":
            self.t += float(self.rng.exponential(1.0 / spec.rate_rps))
            return self.t
        # bursty: Poisson within the current state, exponential state dwells
        while True:
            rate = self.rate_on if self.on else self.rate_off
            gap = float(self.rng.exponential(1.0 / rate))
            if self.t + gap <= self.t_switch:
                self.t += gap
                return self.t
            self.t = self.t_switch
            self.on = not self.on
            dwell = self.dwell_on if self.on else self.dwell_off
            self.t_switch = self.t + float(self.rng.exponential(dwell))


def _sample_length(rng: np.random.Generator, dist: str, lo: int, hi: int,
                   spec: WorkloadSpec) -> int:
    if dist == "fixed":
        return hi
    if dist == "min":
        return lo
    if dist == "uniform":
        return int(rng.integers(lo, hi + 1))
    if dist == "zipf":
        # bounded power law anchored at lo: mostly lo, heavy tail toward hi
        return min(lo - 1 + int(rng.zipf(spec.zipf_a)), hi)
    # lognormal, median anchored a quarter of the way up the range
    mu = math.log(max(float(lo), hi / 4.0))
    draw = int(round(rng.lognormal(mu, spec.lognormal_sigma)))
    return min(max(draw, lo), hi)


def iter_requests(
    spec: WorkloadSpec, seed: int = 0
) -> Iterator[tuple[Request, float]]:
    """Yield ``(request, arrival_time_s)`` lazily, in arrival order.

    One ``default_rng(seed)`` with a fixed per-request draw order
    (arrival, prompt length, budget, tokens, tier), so the trace is a
    pure function of ``(spec, seed)`` — the deterministic-replay
    guarantee the soak harness and the BENCH metadata lean on.  The
    ``spec_fraction`` strategy tag draws come from a *separate* child
    stream (and only when the fraction is nonzero), so turning
    speculation on or off in a preset never shifts the main-stream
    draws above.
    """
    rng = np.random.default_rng(seed)
    spec_rng = (
        np.random.default_rng(np.random.SeedSequence([seed, 0x5BEC]))
        if spec.spec_fraction > 0 else None
    )
    arrivals = _Arrivals(spec, rng)
    if spec.tier_mix:
        tiers = [t for t, _ in spec.tier_mix]
        w = np.asarray([w for _, w in spec.tier_mix], np.float64)
        probs = w / w.sum()
    for i in range(spec.requests):
        t = arrivals.next()
        length = _sample_length(rng, spec.prompt_dist, spec.min_prompt, spec.prompt_len, spec)
        budget = _sample_length(rng, spec.gen_dist, spec.min_gen, spec.max_new, spec)
        tokens = rng.integers(0, spec.vocab_size, size=length).astype(np.int32)
        quality = tiers[int(rng.choice(len(tiers), p=probs))] if spec.tier_mix else None
        strategy = (
            "speculative"
            if spec_rng is not None and spec_rng.random() < spec.spec_fraction
            else None
        )
        yield Request(id=i, tokens=tokens, max_new=budget, eos_id=spec.eos_id,
                      quality=quality, slo_ttft_s=spec.slo_ttft_s,
                      strategy=strategy), t


def iter_windows(
    spec: WorkloadSpec, seed: int = 0, window_size: int = 256
) -> Iterator[tuple[list[Request], list[float]]]:
    """Chunk :func:`iter_requests` into bounded-memory windows.

    Yields ``(requests, arrival_times_s)`` lists of at most
    ``window_size`` entries; only one window is ever materialized.
    """
    if window_size < 1:
        raise ValueError(f"window_size must be >= 1, got {window_size}")
    reqs: list[Request] = []
    times: list[float] = []
    for req, t in iter_requests(spec, seed):
        reqs.append(req)
        times.append(t)
        if len(reqs) == window_size:
            yield reqs, times
            reqs, times = [], []
    if reqs:
        yield reqs, times


def trace_digest(spec: WorkloadSpec, seed: int = 0) -> str:
    """SHA-256 over the full request trace (ids, tokens, budgets, tiers,
    arrival times) — byte-identical traces ⇔ identical digests.  Streams
    over :func:`iter_requests`, so it is memory-bounded too."""
    h = hashlib.sha256()
    h.update(repr((spec, seed)).encode())
    for req, t in iter_requests(spec, seed):
        h.update(np.int64(req.id).tobytes())
        h.update(np.int64(req.prompt_len).tobytes())
        h.update(req.tokens.tobytes())
        h.update(np.int64(req.max_new).tobytes())
        h.update(np.int64(-1 if req.eos_id is None else req.eos_id).tobytes())
        h.update((req.quality or "").encode() + b"\0")
        h.update((req.strategy or "").encode() + b"\0")
        h.update(np.float64(t).tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class Workload:
    """A fully materialized draw — for tests and small benchmark runs;
    soaks should stream :func:`iter_windows` instead."""

    spec: WorkloadSpec
    seed: int
    requests: tuple  # of Request, arrival order
    arrivals_s: tuple  # of float, nondecreasing

    @property
    def offered_rps(self) -> float:
        """Mean offered arrival rate of this draw (inf for immediate)."""
        span = self.arrivals_s[-1] - self.arrivals_s[0] if len(self.arrivals_s) > 1 else 0.0
        return len(self.requests) / span if span > 0 else float("inf")


def generate(spec: WorkloadSpec, seed: int = 0) -> Workload:
    """Materialize one workload draw."""
    reqs, times = [], []
    for req, t in iter_requests(spec, seed):
        reqs.append(req)
        times.append(t)
    return Workload(spec=spec, seed=seed, requests=tuple(reqs), arrivals_s=tuple(times))
