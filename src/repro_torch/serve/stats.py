"""Serve run measurements (a copy of ``repro/serve/stats.py``): aggregate :class:`ServeStats` + :class:`ServeResult`.

``ServeStats`` is the aggregate record both schedulers produce (the
``serve_throughput`` benchmark suite serializes it row-per-run); the
static fields are unchanged from the original ``launch.serve`` loop so
old readers keep working, and the continuous scheduler fills the per-
request distributions (TTFT, end-to-end latency) plus slot utilization.

``ServeResult`` bundles the stats with the per-request outcomes — the
greedy token streams (what the parity tests bit-compare) and one
:class:`~repro.serve.request.RequestStats` per retired request.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.serve.request import RequestStats

__all__ = ["ServeStats", "ServeResult", "SlotAccounting", "percentile", "fmt_ms"]


def percentile(values, q: float) -> Optional[float]:
    """float percentile of a sequence, or ``None`` when it is empty.

    ``None`` (not a sentinel 0.0, which reads as "instant") is the
    empty-distribution answer — callers that render must special-case it
    the way :func:`fmt_ms` does, and JSON rows carry ``null``.  A single
    sample is its own percentile at every ``q``.  ``q`` outside [0, 100]
    is a caller bug and raises here rather than deep inside numpy.
    """
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    vals = list(values)
    if not vals:
        return None
    return float(np.percentile(np.asarray(vals, np.float64), q))


def fmt_ms(values, q: float) -> str:
    """``percentile`` rendered as milliseconds — ``"n/a"`` for an empty
    distribution instead of a misleading ``0ms``."""
    p = percentile(values, q)
    if p is None:
        return "n/a"
    return f"{p * 1e3:.0f}ms"


@dataclasses.dataclass(frozen=True)
class SlotAccounting:
    """Slot-pool conservation ledger of one serve run.

    Counted live inside the scheduler loop (not reconstructed from the
    retired list), so the soak harness audits what actually happened:
    every request *seated* into a slot must eventually be *retired* from
    one (``slot_leaks == 0``), per-slot KV write positions must advance
    by exactly one physical slot per decode step and stay inside the
    cache (``position_violations == 0``), and ``slot_reuse`` records how
    many requests each physical slot hosted — its spread is the
    fragmentation indicator (one cold slot while others churn means the
    refill scan is skewing placement).
    """

    seated: int  # requests seated into a slot (pool prefill + admissions)
    retired: int  # requests retired out of a slot
    pool_prefill_seats: int  # seated by the initial batched prefill
    admission_seats: int  # seated by single-row admission prefills
    max_live: int  # peak live rows in any decode step
    slot_reuse: tuple  # per-slot seat counts, length batch_size ('()' for static)
    position_violations: int  # per-row write-slot monotonicity/bounds failures

    @property
    def slot_leaks(self) -> int:
        """Seated-but-never-retired rows after the run drained (must be 0)."""
        return self.seated - self.retired

    @property
    def reuse_spread(self) -> int:
        """max - min per-slot seat count: 0 = perfectly balanced reuse."""
        if not self.slot_reuse:
            return 0
        return int(max(self.slot_reuse) - min(self.slot_reuse))


@dataclasses.dataclass(frozen=True)
class ServeStats:
    """What one serve run measured (all wall times in seconds)."""

    requests: int
    tokens_out: int  # useful tokens only (per-request budget/EOS-bounded)
    wall_s: float
    prefill_s: float  # total time in prefill (batched or per-admission)
    decode_s: float  # total time in the decode loops
    batch_latencies_s: tuple  # static scheduler: per-batch wall time; else ()
    devices: int
    scheduler: str = "static"  # "static" | "continuous"
    decode_steps: int = 0  # global decode steps executed
    slot_utilization: float = 1.0  # mean fraction of live rows per decode step
    ttft_s: tuple = ()  # per-request time-to-first-token
    request_latencies_s: tuple = ()  # per-request end-to-end latency
    quality: str = ""  # accuracy tier the pool was resolved to ("" = none)
    # ---- open-loop clocked admission (all default-off for old readers)
    open_loop: bool = False  # arrival-clocked admission vs queue drain
    policy: str = ""  # admission policy name ("" = implicit static)
    queue_delay_s: tuple = ()  # open loop: per-request admission - arrival
    tier_switches: int = 0  # pool tier transitions the policy performed
    rejected: int = 0  # requests the policy shed (offered, never served)
    starved: int = 0  # offered but neither served nor shed (must be 0)
    slo_total: int = 0  # offered requests carrying a TTFT SLO
    slo_attained: int = 0  # of those, served with ttft <= slo
    # ---- decode strategy (repro.serve.strategy; default-off for old readers)
    strategy: str = ""  # pool decode strategy ("" = pre-strategy record)
    spec_rounds: int = 0  # decode rounds that actually speculated
    spec_proposed: int = 0  # draft tokens proposed across those rounds
    spec_accepted: int = 0  # of those, accepted by the verify forward
    modeled_cost: float = 0.0  # sum of round costs in exact-step units

    @property
    def spec_rolled_back(self) -> int:
        """Draft tokens proposed but rejected: their KV writes were
        abandoned on the host side (the rollback counter)."""
        return self.spec_proposed - self.spec_accepted

    @property
    def accept_rate(self) -> Optional[float]:
        """Draft-token acceptance over the run, ``None`` when nothing was
        proposed — same no-data-is-not-zero convention as
        :func:`percentile` (a greedy run renders ``accept n/a``, not a
        fake 0%)."""
        if self.spec_proposed == 0:
            return None
        return self.spec_accepted / self.spec_proposed

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def requests_per_s(self) -> float:
        return self.requests / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def slo_attainment(self) -> Optional[float]:
        """Fraction of SLO-carrying *offered* requests served within SLO.

        Rejected/starved SLO requests count against the denominator (a
        shedding policy cannot improve this by refusing work); ``None``
        when no offered request carried an SLO — the same
        no-data-is-not-zero convention as :func:`percentile`.
        """
        if self.slo_total == 0:
            return None
        return self.slo_attained / self.slo_total

    def summary(self) -> str:
        extra = ""
        if self.scheduler == "continuous":
            extra = (
                f", {self.slot_utilization:.0%} slot util, "
                f"ttft p50 {fmt_ms(self.ttft_s, 50)}"
            )
        if self.open_loop:
            # ttft above is arrival-based in open loop; queue delay is its
            # waiting component — both keep the n/a-on-empty guard
            extra += f", queue p50 {fmt_ms(self.queue_delay_s, 50)}"
            att = self.slo_attainment
            extra += f", slo {att:.0%}" if att is not None else ""
            if self.rejected:
                extra += f", {self.rejected} rejected"
            if self.tier_switches:
                extra += f", {self.tier_switches} tier switches"
        if self.strategy and self.strategy != "greedy":
            # closed- and open-loop reports render the same acceptance
            # cell, with the empty-distribution n/a guard: a speculative
            # pool whose rounds never speculated says so instead of 0%
            ar = self.accept_rate
            if ar is None:
                extra += ", accept n/a"
            else:
                extra += (
                    f", accept {ar:.0%} "
                    f"({self.spec_rolled_back} rolled back)"
                )
        pol = f" [{self.policy}]" if self.policy and self.open_loop else ""
        tier = f" [tier {self.quality}]" if self.quality else ""
        strat = (
            f" [{self.strategy}]"
            if self.strategy and self.strategy != "greedy" else ""
        )
        return (
            f"[{self.scheduler}] served {self.requests} requests, "
            f"{self.tokens_out} tokens in {self.wall_s:.2f}s "
            f"({self.tokens_per_s:.1f} tok/s on {self.devices} device(s))"
            + extra + strat + pol + tier
        )


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """Stats + per-request outcomes of one serve run."""

    stats: ServeStats
    request_stats: tuple  # of RequestStats, retirement order
    outputs: dict  # request id -> np.ndarray int32 generated tokens
    accounting: Optional[SlotAccounting] = None  # slot ledger (both loops fill it)
    # of policy.TierSwitch, in order — the autoscaling event stream an
    # SLO-adaptive run produces (empty for static/closed-loop runs)
    tier_switches: tuple = ()
    # of RequestStats with finish_reason "rejected": offered requests the
    # admission policy shed.  Kept out of request_stats/outputs so parity
    # and audit consumers only ever see rows that actually decoded.
    rejected: tuple = ()

    def tokens_for(self, request_id: int) -> np.ndarray:
        return self.outputs[request_id]

    def stats_for(self, request_id: int) -> RequestStats:
        for rs in self.request_stats:
            if rs.id == request_id:
                return rs
        raise KeyError(f"request {request_id} was not served")
