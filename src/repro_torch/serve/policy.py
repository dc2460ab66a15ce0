"""Admission policies: who gets a slot, and at which tier.

Counterpart of ``repro/serve/policy.py`` for the closed loop: the base
:class:`AdmissionPolicy` and :class:`StaticTier` (admit everything at the
pool's tier), which is what the closed-loop scheduler consults.  The
open-loop policies ``SLOAdaptive`` and ``Reject`` are not ported yet
(ROADMAP.md, 'Modules to port' item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serve.request import Request, RequestStats

__all__ = ["AdmissionPolicy", "LoadSnapshot", "StaticTier"]


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
