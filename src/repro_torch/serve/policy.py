"""Admission policies: who gets a slot, and at which tier.

Counterpart of ``repro/serve/policy.py``.  The scheduler consults an
:class:`AdmissionPolicy` once per control tick:

* :class:`StaticTier` -- always admit, always the pool's tier (the
  closed loop's implicit policy and the bit-match oracle);
* :class:`SLOAdaptive` -- the accuracy knob under closed-loop control:
  one rung down the ladder (e.g. ``high -> balanced -> draft``) when the
  queue or the rolling TTFT tail breaches the SLO, one rung up after a
  healthy streak, with a minimum dwell between switches, so the switch
  sequence is a deterministic function of the trace;
* :class:`Reject` -- load shedding beyond a queue-depth bound.

The same weights serve every tier, so a switch costs an engine lookup, not
a model reload.  Policies are stateful per run (``begin`` resets them) and
observe retirements (``observe``); ``tier`` / ``admit`` are pure functions
of that state and the :class:`LoadSnapshot`, so a replayed trace replays
the decisions.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

from repro_torch.serve.request import Request, RequestStats
from repro_torch.serve.stats import percentile

__all__ = [
    "AdmissionPolicy",
    "LoadSnapshot",
    "TierSwitch",
    "StaticTier",
    "SLOAdaptive",
    "Reject",
    "POLICIES",
    "get_policy",
]


@dataclasses.dataclass(frozen=True)
class LoadSnapshot:
    """What the scheduler can tell a policy at one control tick.

    Pure load facts only — latency history lives inside the policy (fed
    by ``observe``), so the snapshot stays cheap and the policy owns its
    own window semantics.  ``now_s`` is clock time (virtual seconds in
    the deterministic open-loop clock, wall seconds otherwise).
    """

    now_s: float
    step: int  # global decode steps executed so far
    queue_depth: int  # arrived requests waiting for a slot
    pending: int  # generated but not yet arrived (open loop)
    live_rows: int
    batch_size: int
    head_wait_s: float = 0.0  # how long the queue head has been waiting


@dataclasses.dataclass(frozen=True)
class TierSwitch:
    """One recorded tier transition (the autoscaling event stream)."""

    step: int
    now_s: float
    from_tier: str
    to_tier: str
    reason: str  # "degrade:<signal>" | "recover"


class AdmissionPolicy:
    """Base policy: admit everything at the pool's own tier.

    Subclasses override :meth:`tier` (which accuracy tier the pool
    should run at this control tick) and/or :meth:`admit` (whether the
    queue head gets the free slot).  ``enforces_tier_tags`` keeps the
    legacy sold-at-tier admission check: policies that *own* the tier
    (SLOAdaptive) turn it off, because a request sold at ``high`` being
    served at ``balanced`` under pressure is the feature, not a bug —
    the served tier is recorded per request instead.
    """

    name = "static"
    enforces_tier_tags = True
    _pool_tier: Optional[str] = None

    def begin(self, pool_tier: Optional[str]) -> None:
        """Reset per-run state; ``pool_tier`` is the pool's resolved tier."""
        self._pool_tier = pool_tier

    def tier(self, snap: LoadSnapshot) -> Optional[str]:
        """Tier to serve at for this control tick (None = pool base config)."""
        return self._pool_tier

    def admit(self, req: Request, snap: LoadSnapshot) -> bool:
        """Whether to seat ``req`` now; False sheds it (recorded, never served)."""
        return True

    def speculation(self, snap: LoadSnapshot) -> bool:
        """Whether a speculative pool should speculate this round.

        Only consulted on pools whose decode strategy speculates at all
        (a greedy pool ignores it).  The base policy always says yes —
        the strategy itself already falls back to plain decode when no
        live row wants speculation; :class:`SLOAdaptive` instead gates
        on the modeled gain at the tier it is currently serving.
        """
        return True

    def observe(self, rs: RequestStats) -> None:
        """Feed one retirement record (rolling-window latency signals)."""

    @property
    def switches(self) -> tuple:
        """Tier-switch events recorded so far, in order."""
        return ()


class StaticTier(AdmissionPolicy):
    """Today's behavior as a policy object: the closed-loop bit-match oracle."""

    name = "static"


class Reject(AdmissionPolicy):
    """Load-shedding baseline: refuse arrivals beyond a queue-depth bound.

    ``max_queue_depth`` defaults to ``depth_factor * batch_size`` —
    roughly "one full pool refill already waiting".  Shedding keeps the
    served requests' latency flat at the price of rejected traffic; an
    adaptive tier policy has to beat this on SLO attainment *without*
    turning users away.
    """

    name = "reject"

    def __init__(self, *, max_queue_depth: Optional[int] = None,
                 depth_factor: float = 4.0):
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got {max_queue_depth}")
        if depth_factor <= 0:
            raise ValueError(f"depth_factor must be > 0, got {depth_factor}")
        self.max_queue_depth = max_queue_depth
        self.depth_factor = depth_factor

    def admit(self, req: Request, snap: LoadSnapshot) -> bool:
        bound = self.max_queue_depth
        if bound is None:
            bound = max(1, int(self.depth_factor * snap.batch_size))
        return snap.queue_depth <= bound


class SLOAdaptive(AdmissionPolicy):
    """SLO-closed-loop tier control with hysteresis.

    Control signals, evaluated once per tick against the target:

    * **Queue pressure** — ``queue_depth > queue_high * batch_size``
      (burst backpressure shows up here first);
    * **Tail latency** — rolling-window TTFT ``pctl`` percentile above
      ``slo_ttft_s`` (the lagging confirmation).

    A tick is a *breach* when either fires, *healthy* when the queue is
    back under ``queue_low * batch_size`` and the TTFT tail is within
    SLO.  ``degrade_after`` consecutive breaches move one rung down the
    ``ladder`` (toward cheaper tiers), ``recover_after`` consecutive
    healthy ticks move one rung up; every switch re-arms a
    ``min_dwell_ticks`` refractory window during which no further
    switch can happen.  Degrading needs a short streak (react to the
    burst), recovering a long one (don't flap on the first quiet step)
    — the asymmetry plus the dwell is the hysteresis that makes the
    switch sequence deterministic and oscillation-free on a seeded
    trace.

    The ladder is validated against ``engine.config`` at construction
    and each rung's controller resolution is pre-computed
    (``resolutions``), so an unregistered or uncertifiable tier fails
    fast, not mid-burst.
    """

    name = "slo-adaptive"
    enforces_tier_tags = False  # the policy owns the served tier

    def __init__(
        self,
        *,
        slo_ttft_s: float = 0.25,
        ladder: tuple = ("high", "balanced", "draft"),
        pctl: float = 95.0,
        queue_high: float = 2.0,
        queue_low: float = 0.5,
        degrade_after: int = 2,
        recover_after: int = 8,
        min_dwell_ticks: int = 8,
        window: int = 64,
        spec_draft_tier: str = "draft",
        spec_k: int = 4,
    ):
        from repro_torch.engine import config as engine_config

        if slo_ttft_s <= 0:
            raise ValueError(f"slo_ttft_s must be > 0, got {slo_ttft_s}")
        if len(ladder) < 2:
            raise ValueError(f"ladder needs >= 2 tiers to adapt, got {ladder!r}")
        if not 0 < queue_low <= queue_high:
            raise ValueError(
                f"need 0 < queue_low <= queue_high, got {queue_low}/{queue_high}"
            )
        if degrade_after < 1 or recover_after < 1 or min_dwell_ticks < 0:
            raise ValueError("degrade_after/recover_after must be >= 1, "
                             "min_dwell_ticks >= 0")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        # canonicalize + resolve every rung through the controller now:
        # the ladder can only name registered tiers whose (n, t) the
        # engine.config controller certifies.
        self.ladder = tuple(engine_config.get_tier(t).name for t in ladder)
        self.resolutions = {
            t: engine_config.resolve_tier(t) for t in self.ladder
        }
        self.slo_ttft_s = slo_ttft_s
        self.pctl = pctl
        self.queue_high, self.queue_low = queue_high, queue_low
        self.degrade_after, self.recover_after = degrade_after, recover_after
        self.min_dwell_ticks = min_dwell_ticks
        self.window = window
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        self.spec_draft_tier = engine_config.get_tier(spec_draft_tier).name
        self.spec_k = spec_k
        self.begin(None)

    def begin(self, pool_tier: Optional[str]) -> None:
        self._pool_tier = pool_tier
        # start at the pool's rung when it sits on the ladder, else at the
        # most accurate rung — degradation is something load must earn
        self._rung = self.ladder.index(pool_tier) if pool_tier in self.ladder else 0
        self._ttft = collections.deque(maxlen=self.window)
        self._breaches = 0
        self._healthy = 0
        self._ticks = 0
        self._last_switch_tick = -(10**9)  # no refractory window at start
        self._switches: list = []

    def observe(self, rs: RequestStats) -> None:
        self._ttft.append(rs.ttft_s)

    def _signals(self, snap: LoadSnapshot) -> tuple:
        tail = percentile(self._ttft, self.pctl)
        queue_hot = snap.queue_depth > self.queue_high * snap.batch_size
        ttft_hot = tail is not None and tail > self.slo_ttft_s
        calm = (snap.queue_depth <= self.queue_low * snap.batch_size
                and not ttft_hot)
        reason = "queue" if queue_hot else "ttft"
        return queue_hot or ttft_hot, calm, reason

    def tier(self, snap: LoadSnapshot) -> Optional[str]:
        self._ticks += 1
        breach, calm, reason = self._signals(snap)
        self._breaches = self._breaches + 1 if breach else 0
        self._healthy = self._healthy + 1 if calm else 0
        dwelling = self._ticks - self._last_switch_tick <= self.min_dwell_ticks
        if not dwelling:
            if (breach and self._breaches >= self.degrade_after
                    and self._rung < len(self.ladder) - 1):
                self._switch(snap, self._rung + 1, f"degrade:{reason}")
            elif (calm and self._healthy >= self.recover_after
                    and self._rung > 0):
                self._switch(snap, self._rung - 1, "recover")
        return self.ladder[self._rung]

    def speculation(self, snap: LoadSnapshot) -> bool:
        """Speculate only while the modeled gain at the *currently served*
        rung beats plain decode: the closed-form accept-rate bound
        (``engine.config.accept_rate_estimate``) and the gate-delay cost
        model decide, so a pool already degraded to the draft rung stops
        speculating against itself (gain exactly 1.0) instead of burning
        k wasted proposal steps per round.  Deterministic: a pure
        function of the rung, so a replayed trace replays the decisions."""
        from repro_torch.engine.config import speculation_gain

        return speculation_gain(
            self.spec_draft_tier, self.ladder[self._rung], self.spec_k
        ) > 1.0

    def _switch(self, snap: LoadSnapshot, rung: int, reason: str) -> None:
        self._switches.append(TierSwitch(
            step=snap.step, now_s=snap.now_s,
            from_tier=self.ladder[self._rung], to_tier=self.ladder[rung],
            reason=reason,
        ))
        self._rung = rung
        self._last_switch_tick = self._ticks
        self._breaches = self._healthy = 0

    @property
    def switches(self) -> tuple:
        return tuple(self._switches)


POLICIES = {
    "static": StaticTier,
    "slo-adaptive": SLOAdaptive,
    "reject": Reject,
}


def get_policy(policy, **kwargs) -> AdmissionPolicy:
    """Resolve a policy name (or pass an instance through) for the CLIs."""
    if isinstance(policy, AdmissionPolicy):
        if kwargs:
            raise ValueError("cannot pass policy kwargs with a policy instance")
        return policy
    try:
        cls = POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown admission policy {policy!r}; known: {sorted(POLICIES)}"
        ) from None
    return cls(**kwargs)
