"""Continuous-batching serve subsystem (counterpart of ``repro/serve``).

* :class:`~repro_torch.serve.request.Request` / ``synth_requests`` -- what
  the scheduler consumes and the deterministic queue generator;
* :class:`~repro_torch.serve.scheduler.ContinuousScheduler` /
  ``continuous_serve_loop`` -- slot-based admission, per-row positions and
  retirement, closed or open loop; ``static_serve_loop`` -- the static-batch
  baseline and oracle;
* :class:`~repro_torch.serve.stats.ServeStats` / ``ServeResult`` /
  ``SlotAccounting`` -- what a run measures and returns;
* :class:`~repro_torch.serve.policy.AdmissionPolicy` (``StaticTier`` /
  ``SLOAdaptive`` / ``Reject``) -- admission and accuracy-tier control;
* :class:`~repro_torch.serve.strategy.DecodeStrategy` (``GreedyDecode`` /
  ``SelfSpeculative``) -- the decode round;
* :class:`~repro_torch.serve.workload.WorkloadSpec` / ``preset_spec`` --
  traffic-realistic workloads;
* :func:`~repro_torch.serve.soak.run_soak` / ``SoakReport`` -- the windowed
  soak harness.
"""

from repro_torch.serve.policy import (
    AdmissionPolicy,
    LoadSnapshot,
    Reject,
    SLOAdaptive,
    StaticTier,
    TierSwitch,
    get_policy,
)
from repro_torch.serve.request import Request, RequestStats, synth_requests
from repro_torch.serve.scheduler import (
    ContinuousScheduler,
    continuous_serve_loop,
    static_serve_loop,
    supports_continuous,
)
from repro_torch.serve.soak import SoakReport, probe_eos_id, run_soak
from repro_torch.serve.stats import ServeResult, ServeStats, SlotAccounting
from repro_torch.serve.strategy import (
    DecodeStrategy,
    GreedyDecode,
    RoundResult,
    RowView,
    SelfSpeculative,
    TierEngine,
    build_tier_engine,
    get_strategy,
)
from repro_torch.serve.workload import Workload, WorkloadSpec, preset_spec

__all__ = [
    "Request",
    "RequestStats",
    "synth_requests",
    "ContinuousScheduler",
    "continuous_serve_loop",
    "static_serve_loop",
    "supports_continuous",
    "AdmissionPolicy",
    "LoadSnapshot",
    "TierSwitch",
    "StaticTier",
    "SLOAdaptive",
    "Reject",
    "get_policy",
    "DecodeStrategy",
    "GreedyDecode",
    "SelfSpeculative",
    "RoundResult",
    "RowView",
    "TierEngine",
    "build_tier_engine",
    "get_strategy",
    "ServeResult",
    "ServeStats",
    "SlotAccounting",
    "Workload",
    "WorkloadSpec",
    "preset_spec",
    "SoakReport",
    "probe_eos_id",
    "run_soak",
]
