"""Continuous-batching serve subsystem (counterpart of ``repro/serve``).

* :class:`~repro_torch.serve.request.Request` / ``synth_requests``;
* :class:`~repro_torch.serve.scheduler.ContinuousScheduler` /
  ``continuous_serve_loop`` (closed loop);
* :class:`~repro_torch.serve.stats.ServeStats` / ``ServeResult`` /
  ``SlotAccounting``;
* :class:`~repro_torch.serve.policy.AdmissionPolicy` / ``StaticTier``;
* :class:`~repro_torch.serve.strategy.GreedyDecode` / ``TierEngine``.
"""

from repro_torch.serve.policy import AdmissionPolicy, LoadSnapshot, StaticTier
from repro_torch.serve.request import Request, RequestStats, synth_requests
from repro_torch.serve.scheduler import ContinuousScheduler, continuous_serve_loop
from repro_torch.serve.stats import ServeResult, ServeStats, SlotAccounting
from repro_torch.serve.strategy import GreedyDecode, TierEngine, build_tier_engine

__all__ = [
    "AdmissionPolicy", "ContinuousScheduler", "GreedyDecode", "LoadSnapshot", "Request",
    "RequestStats", "ServeResult", "ServeStats", "SlotAccounting", "StaticTier",
    "TierEngine", "build_tier_engine", "continuous_serve_loop", "synth_requests",
]
