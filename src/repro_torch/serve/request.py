"""Serve-side request model (a copy of ``repro/serve/request.py``): what enters the scheduler and what it reports.

A :class:`Request` is one generation job — a prompt (true, unpadded
token ids), a per-request generation budget, and an optional EOS id.
The scheduler retires a row the moment either terminates it, which is
exactly the behavior a static batch cannot express (a finished row there
burns dead decode steps until the whole batch drains).

:func:`synth_requests` builds the mixed-length / mixed-budget workload
shared by the CLI, the ``serve_throughput`` benchmark suite, and the
scheduler tests — one generator, so "same seed ⇒ same queue" holds
across all three.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Request", "RequestStats", "synth_requests"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request (true prompt, no padding)."""

    id: int
    tokens: np.ndarray  # (L,) int32 prompt token ids, L >= 1
    max_new: int  # generation budget (>= 1)
    eos_id: Optional[int] = None  # retire early on this token, if set
    # accuracy tier the request was sold at (a repro.engine.config tier
    # name).  None = whatever the pool runs.  Tier-enforcing admission
    # policies check the tier against the pool's resolved engine config
    # at admission — one pool serves one tier, mismatches are rejected
    # rather than served at silently different quality.  Under an
    # SLO-adaptive policy the tag is instead the *preferred* tier: the
    # pool may serve the request cheaper under pressure, and the tier
    # actually used is recorded in ``RequestStats.tier_served``.
    quality: Optional[str] = None
    # per-request TTFT service-level objective, in seconds.  None = no
    # SLO.  The open-loop scheduler scores attainment (first token
    # within the SLO, measured from *arrival*) over every offered
    # request carrying one — rejected requests count as missed, so a
    # load-shedding policy cannot game the metric.
    slo_ttft_s: Optional[float] = None
    # decode-strategy preference (repro.serve.strategy).  None = ride the
    # pool's strategy.  On a speculative pool, "greedy" opts the round
    # out of speculation when no live row wants it; "speculative" asks
    # for it.  Never changes the token stream — committed tokens are
    # always the verify engine's argmax — only the round shape/cost.
    strategy: Optional[str] = None

    def __post_init__(self):
        if len(self.tokens) < 1:
            raise ValueError(f"request {self.id}: empty prompt")
        if self.max_new < 1:
            raise ValueError(f"request {self.id}: max_new must be >= 1, got {self.max_new}")
        if self.slo_ttft_s is not None and self.slo_ttft_s <= 0:
            raise ValueError(
                f"request {self.id}: slo_ttft_s must be > 0, got {self.slo_ttft_s}"
            )
        if self.strategy not in (None, "greedy", "speculative"):
            raise ValueError(
                f"request {self.id}: unknown strategy {self.strategy!r} "
                f"(expected None, 'greedy' or 'speculative')"
            )

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass(frozen=True)
class RequestStats:
    """Per-request serving record.

    Closed loop: times are seconds from run start (the legacy
    semantics, unchanged).  Open loop: ``ttft_s`` and ``latency_s`` are
    re-based to the request's *arrival* time — what the client
    experiences, queueing included — and ``queue_delay_s`` separates the
    waiting component out (``ttft_s = queue_delay_s + admission cost``).
    """

    id: int
    prompt_len: int
    tokens_out: int
    admit_step: int  # global decode step at admission (0 == initial fill)
    ttft_s: float  # time to first token (queue wait + admission prefill)
    latency_s: float  # time to retirement
    finish_reason: str  # "budget" | "eos" | "rejected"
    arrival_s: float = 0.0  # open loop: arrival time on the run clock
    queue_delay_s: Optional[float] = None  # open loop: admission - arrival
    tier_served: str = ""  # accuracy tier actually served ("" = pool config)
    slo_ttft_s: Optional[float] = None  # the request's TTFT SLO, if any
    proposed: int = 0  # speculative rounds: draft tokens proposed for this row
    accepted: int = 0  # of those, accepted by the verify forward

    @property
    def rolled_back(self) -> int:
        """Draft tokens whose KV writes were abandoned (never committed)."""
        return self.proposed - self.accepted

    @property
    def accept_rate(self) -> Optional[float]:
        """Per-request draft acceptance, ``None`` when nothing was proposed
        (the no-data-is-not-zero convention of ``stats.percentile``)."""
        if self.proposed == 0:
            return None
        return self.accepted / self.proposed


def synth_requests(
    count: int,
    *,
    prompt_len: int,
    gen: int,
    vocab_size: int,
    seed: int = 0,
    min_prompt: int = 4,
    vary_budget: bool = True,
    eos_id: Optional[int] = None,
    quality: Optional[str] = None,
    workload: Optional[str] = None,
    tier_mix: tuple = (),
) -> list[Request]:
    """Deterministic mixed workload: prompt lengths in [min_prompt, prompt_len],
    budgets in [1, gen] (or all ``gen`` when ``vary_budget=False``);
    ``quality`` tags every request with an accuracy tier name.

    ``workload`` opts into a :mod:`repro_torch.serve.workload` traffic preset
    (``"steady"``/``"bursty"``/``"flood"``/``"churn"``): the request list
    is then drawn from that preset's arrival/length/tier models
    (``tier_mix`` weights tier tags; it defaults to tagging everything
    ``quality`` when that is set).  The default (``workload=None``) is the
    uniform draw.  Both are byte-identical to the reference's for a seed.
    """
    if workload is not None:
        from repro_torch.serve import workload as wl

        if not tier_mix and quality is not None:
            tier_mix = ((quality, 1.0),)
        spec = wl.preset_spec(
            workload, requests=count, prompt_len=prompt_len, max_new=gen,
            vocab_size=vocab_size, tier_mix=tier_mix, eos_id=eos_id,
            min_prompt=min(min_prompt, prompt_len),
        )
        return [req for req, _ in wl.iter_requests(spec, seed)]
    rng = np.random.default_rng(seed)
    out: list[Request] = []
    for i in range(count):
        lo = min(min_prompt, prompt_len)
        length = int(rng.integers(lo, prompt_len + 1))
        budget = int(rng.integers(1, gen + 1)) if vary_budget else gen
        out.append(Request(
            id=i,
            tokens=rng.integers(0, vocab_size, size=length).astype(np.int32),
            max_new=budget,
            eos_id=eos_id,
            quality=quality,
        ))
    return out
