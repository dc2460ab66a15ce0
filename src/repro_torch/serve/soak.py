"""Soak harness: stream a workload through a scheduler, audit every window.

A copy of ``repro/serve/soak.py``.

Tens of thousands of :mod:`repro_torch.serve.workload` requests stream
through :class:`~repro_torch.serve.scheduler.ContinuousScheduler` (or the static
baseline) in **bounded-memory windows**, and after every window the
harness audits the invariants a slot-pool scheduler must keep under
realistic traffic:

* **Slot conservation** — the scheduler's own
  :class:`~repro_torch.serve.stats.SlotAccounting` ledger must balance
  (``seated == retired``: no slot leaks) and every window request must
  be served exactly once (no losses, no duplicates across windows).
* **Monotone per-row positions** — per-slot KV write indices advance by
  exactly one physical slot per decode step and stay inside the cache
  (``position_violations == 0``, counted inside the decode loop itself).
* **Bounded outputs** — every retired request emitted between 1 and its
  budget of tokens.
* **Tail-latency stability** — per-window TTFT p99/p999; the drift of
  later windows' p99 against the first window is the leak detector a
  counter can't express (a slow leak shows up as monotonically rising
  tails long before anything crashes).
* **Parity spot-checks** — sampled request ids are re-served alone,
  unpadded, through the static oracle and must bit-match the soak
  stream.  Only on *exact* continuous pools: the static loop's
  shared-``arange`` positions make its own padded streams diverge from
  unpadded by construction, and approximate tiers quantize with
  batch-dependent artifacts, so their bit-parity is only defined
  batch-for-batch, not across batch compositions.

``run_soak`` returns a :class:`SoakReport`; ``report.ok`` is the CI
verdict and ``report.summary_row()`` the flat dict the ``serve_soak``
benchmark suite emits.  The CLI lives at ``repro_torch.launch.soak``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.serve.policy import AdmissionPolicy, StaticTier, get_policy
from repro_torch.serve.scheduler import (
    ContinuousScheduler,
    _apply_pool_quality,
    static_serve_loop,
)
from repro_torch.serve.stats import percentile
from repro_torch.serve.workload import WorkloadSpec, iter_requests, iter_windows, tier_mix_label
from repro_torch.train.steps import mrope_positions

__all__ = ["WindowAudit", "SoakReport", "probe_eos_id", "run_soak", "teacher_gaps"]


def teacher_gaps(model, params, req, stream) -> list:
    """The top-2 logit gap of each greedy step of ``stream``, by one forward
    of the prompt and the stream (teacher forcing) at batch 1, unpadded."""
    toks = np.concatenate([req.tokens, stream[:-1]]).astype(np.int64)
    dev = params.embed.device
    with torch.inference_mode():
        x = torch.as_tensor(toks[None], device=dev)
        pos = mrope_positions(model.cfg, torch.arange(len(toks), device=dev)[None])
        hidden, _, _ = model.forward(params, x, pos, model.ctx())
        logits = model.lm_head(params, hidden[:, req.prompt_len - 1:])[0]
        top2 = torch.topk(logits.float(), 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).tolist()


def probe_eos_id(
    model, params, spec: WorkloadSpec, *, seed: int = 0, probes: int = 5,
    quality=None,
) -> int:
    """The pool's *modal greedy first token* over a few probe prompts.

    EOS emission depends on model weights, so a workload cannot hardcode
    an ``eos_id`` that actually fires; probing the modal first token
    gives the trace an EOS the pool genuinely emits — the ``churn``
    preset uses it (``WorkloadSpec.eos_probe``) to turn budget-capped
    retirement into true instant-EOS retirement.  The probe draws its
    prompts from a decorrelated seed (so the soak trace itself is
    untouched) and serves each alone, unpadded, at the pool's tier;
    ties break toward the smallest token id for determinism.
    """
    if probes < 1:
        raise ValueError(f"probes must be >= 1, got {probes}")
    probe_spec = dataclasses.replace(
        spec, requests=probes, eos_id=None, eos_probe=False, tier_mix=(),
    )
    counts: dict[int, int] = {}
    for req, _ in iter_requests(probe_spec, seed + 7919):
        one = dataclasses.replace(req, max_new=1, eos_id=None, quality=None)
        alone = static_serve_loop(
            model, params, [one], batch_size=1, prompt_len=one.prompt_len,
            gen=1, warmup=False, quality=quality,
        )
        tok = int(alone.outputs[one.id][0])
        counts[tok] = counts.get(tok, 0) + 1
    return max(sorted(counts), key=lambda t: counts[t])


@dataclasses.dataclass(frozen=True)
class WindowAudit:
    """What one window measured and whether its invariants held."""

    index: int
    requests: int
    tokens_out: int
    decode_steps: int
    wall_s: float
    slot_utilization: float
    seated: int
    retired: int
    slot_leaks: int
    position_violations: int
    lost_requests: int
    duplicate_serves: int
    max_live: int
    offered_rps: float  # arrival rate offered by this window's slice
    ttft_p50_s: Optional[float]
    ttft_p99_s: Optional[float]
    ttft_p999_s: Optional[float]
    violations: tuple  # of str; empty == clean window
    rejected: int = 0  # requests the admission policy shed this window
    eos_retired: int = 0  # rows retired by EOS emission (vs budget)
    queue_delay_p99_s: Optional[float] = None  # open loop only
    tier_switches: int = 0  # pool tier transitions this window
    slo_total: int = 0
    slo_attained: int = 0


@dataclasses.dataclass(frozen=True)
class SoakReport:
    """Aggregate verdict of one soak run."""

    workload: str
    arrival: str
    tier_mix: str
    scheduler: str
    quality: str
    seed: int
    requests: int
    batch_size: int
    window_size: int
    windows: tuple  # of WindowAudit
    retirement_order: tuple  # request ids in global retirement order
    slot_reuse: tuple  # per-slot seat counts summed over windows
    ttft_drift_p99: float  # max later-window p99 / first-window p99
    drift_limit: Optional[float]
    spot_checks: int
    spot_check_failures: int
    violations: tuple  # of str, aggregated over windows + run-level checks
    loop: str = "closed"  # "closed" (queue drain) | "open" (arrival clocks)
    policy: str = ""  # admission policy name ("" = implicit static)
    strategy: str = ""  # pool decode strategy ("" = default greedy)

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def rejected(self) -> int:
        return sum(w.rejected for w in self.windows)

    @property
    def eos_retired(self) -> int:
        return sum(w.eos_retired for w in self.windows)

    @property
    def tier_switches(self) -> int:
        return sum(w.tier_switches for w in self.windows)

    @property
    def slo_attainment(self) -> Optional[float]:
        total = sum(w.slo_total for w in self.windows)
        if total == 0:
            return None
        return sum(w.slo_attained for w in self.windows) / total

    @property
    def tokens_out(self) -> int:
        return sum(w.tokens_out for w in self.windows)

    @property
    def wall_s(self) -> float:
        return sum(w.wall_s for w in self.windows)

    @property
    def decode_steps(self) -> int:
        return sum(w.decode_steps for w in self.windows)

    @property
    def slot_utilization(self) -> float:
        """Decode-step-weighted mean slot utilization over windows."""
        steps = sum(w.decode_steps for w in self.windows)
        if steps == 0:
            return 1.0
        return sum(w.slot_utilization * w.decode_steps for w in self.windows) / steps

    @property
    def reuse_spread(self) -> int:
        if not self.slot_reuse:
            return 0
        return int(max(self.slot_reuse) - min(self.slot_reuse))

    def summary_row(self) -> dict:
        """Flat dict for the ``serve_soak`` BENCH rows (and ``--json``)."""
        wall = self.wall_s
        ttft_all_p50 = percentile([w.ttft_p50_s for w in self.windows
                                   if w.ttft_p50_s is not None], 50)
        worst_p99 = max((w.ttft_p99_s for w in self.windows
                         if w.ttft_p99_s is not None), default=None)
        worst_p999 = max((w.ttft_p999_s for w in self.windows
                          if w.ttft_p999_s is not None), default=None)
        worst_queue_p99 = max((w.queue_delay_p99_s for w in self.windows
                               if w.queue_delay_p99_s is not None), default=None)
        att = self.slo_attainment
        return {
            "workload": self.workload,
            "arrival": self.arrival,
            "tier_mix": self.tier_mix,
            "scheduler": self.scheduler,
            "quality": self.quality,
            "loop": self.loop,
            "policy": self.policy or "static",
            "strategy": self.strategy or "greedy",
            "seed": self.seed,
            "requests": self.requests,
            "batch_size": self.batch_size,
            "window_size": self.window_size,
            "window_count": len(self.windows),
            "tokens_out": self.tokens_out,
            "decode_steps": self.decode_steps,
            "wall_s": round(wall, 4),
            "tokens_per_s": round(self.tokens_out / wall, 2) if wall > 0 else 0.0,
            "slot_utilization": round(self.slot_utilization, 4),
            "seated": sum(w.seated for w in self.windows),
            "retired": sum(w.retired for w in self.windows),
            "slot_leaks": sum(w.slot_leaks for w in self.windows),
            "position_violations": sum(w.position_violations for w in self.windows),
            "lost_requests": sum(w.lost_requests for w in self.windows),
            "duplicate_serves": sum(w.duplicate_serves for w in self.windows),
            "max_live": max((w.max_live for w in self.windows), default=0),
            "reuse_spread": self.reuse_spread,
            "ttft_p50_s": None if ttft_all_p50 is None else round(ttft_all_p50, 4),
            "ttft_p99_s_worst": None if worst_p99 is None else round(worst_p99, 4),
            "ttft_p999_s_worst": None if worst_p999 is None else round(worst_p999, 4),
            "ttft_drift_p99": round(self.ttft_drift_p99, 3),
            "rejected": self.rejected,
            "eos_retired": self.eos_retired,
            "tier_switches": self.tier_switches,
            "queue_delay_p99_s_worst": (
                None if worst_queue_p99 is None else round(worst_queue_p99, 4)
            ),
            "slo_attainment": None if att is None else round(att, 4),
            "spot_checks": self.spot_checks,
            "spot_check_failures": self.spot_check_failures,
            "violation_count": len(self.violations),
            "invariants_ok": 1.0 if self.ok else 0.0,
        }

    def describe(self) -> str:
        verdict = "PASS" if self.ok else f"FAIL ({len(self.violations)} violations)"
        return (
            f"[soak {self.workload}/{self.scheduler}] {self.requests} requests "
            f"in {len(self.windows)} windows of {self.window_size}: "
            f"{self.tokens_out} tokens, {self.slot_utilization:.0%} slot util, "
            f"ttft p99 drift {self.ttft_drift_p99:.2f}x, "
            f"{self.spot_checks - self.spot_check_failures}/{self.spot_checks} "
            f"parity spot-checks — {verdict}"
        )


def _audit_window(k, window_reqs, times, result, served_ids) -> WindowAudit:
    """Cross-check one window's ServeResult against what was offered.

    An admission policy may legitimately *shed* requests: a rejected id
    counts as handled exactly once (it must not read as lost, must not
    be served too, and still participates in cross-window duplicate
    detection), and ``served + rejected`` must cover the whole window —
    anything else is starvation, which is always a violation.
    """
    stats, acct = result.stats, result.accounting
    by_id = {r.id: r for r in window_reqs}
    out_ids = set(result.outputs)
    rej_ids = {rs.id for rs in result.rejected}
    handled = out_ids | rej_ids
    lost = sorted(set(by_id) - handled)
    alien = sorted(handled - set(by_id))
    dup = sorted((out_ids & rej_ids) | (handled & served_ids))
    served_ids |= handled

    violations = []
    if stats.requests + stats.rejected != len(window_reqs):
        violations.append(
            f"window {k}: served {stats.requests} + rejected {stats.rejected} "
            f"of {len(window_reqs)} requests"
        )
    if stats.starved != 0:
        violations.append(f"window {k}: {stats.starved} starved requests")
    if lost:
        violations.append(f"window {k}: lost requests {lost[:8]}")
    if alien:
        violations.append(f"window {k}: served ids never offered {alien[:8]}")
    if dup:
        violations.append(f"window {k}: ids served twice {dup[:8]}")
    if acct.slot_leaks != 0:
        violations.append(
            f"window {k}: slot leak — seated {acct.seated} != retired {acct.retired}"
        )
    if acct.position_violations != 0:
        violations.append(
            f"window {k}: {acct.position_violations} per-row write-position violations"
        )
    for rs in result.request_stats:
        req = by_id.get(rs.id)
        if req is not None and not 1 <= rs.tokens_out <= req.max_new:
            violations.append(
                f"window {k}: request {rs.id} emitted {rs.tokens_out} tokens "
                f"(budget {req.max_new})"
            )
            break  # one representative per window keeps the report readable

    span = times[-1] - times[0] if len(times) > 1 else 0.0
    return WindowAudit(
        index=k,
        requests=len(window_reqs),
        tokens_out=stats.tokens_out,
        decode_steps=stats.decode_steps,
        wall_s=stats.wall_s,
        slot_utilization=stats.slot_utilization,
        seated=acct.seated,
        retired=acct.retired,
        slot_leaks=acct.slot_leaks,
        position_violations=acct.position_violations,
        lost_requests=len(lost),
        duplicate_serves=len(dup),
        max_live=acct.max_live,
        offered_rps=len(window_reqs) / span if span > 0 else float("inf"),
        ttft_p50_s=percentile(stats.ttft_s, 50),
        ttft_p99_s=percentile(stats.ttft_s, 99),
        ttft_p999_s=percentile(stats.ttft_s, 99.9),
        violations=tuple(violations),
        rejected=stats.rejected,
        eos_retired=sum(
            1 for rs in result.request_stats if rs.finish_reason == "eos"
        ),
        queue_delay_p99_s=percentile(stats.queue_delay_s, 99),
        tier_switches=stats.tier_switches,
        slo_total=stats.slo_total,
        slo_attained=stats.slo_attained,
    )


def run_soak(
    model,
    params,
    spec: WorkloadSpec,
    *,
    batch_size: int,
    seed: int = 0,
    window_size: int = 256,
    scheduler: str = "continuous",
    quality=None,
    drift_limit: Optional[float] = None,
    spot_check: int = 0,
    progress: Optional[Callable[[WindowAudit], None]] = None,
    loop: str = "closed",
    policy=None,
    step_time_s: float = 0.01,
    clock: str = "virtual",
    strategy=None,
) -> SoakReport:
    """Stream ``spec``'s workload through the scheduler, window by window.

    Args:
      spec, seed: the workload draw (``workload.iter_windows(spec, seed)``).
        A spec with ``eos_probe`` set (the ``churn`` preset) first probes
        the pool's modal greedy first token (:func:`probe_eos_id`) and
        stamps it as the trace's ``eos_id``.
      batch_size: slot-pool size; the prompt bucket / generation capacity
        come from ``spec.prompt_len`` / ``spec.max_new``.
      window_size: requests per window; one window is materialized at a
        time and each runs to completion before it is audited.
      scheduler: ``"continuous"`` or ``"static"`` (the baseline loop;
        parity spot-checks are skipped there, see module docstring).
      quality: pool accuracy tier; tier-tagged requests in the workload
        are checked against it at admission (tier-enforcing policies).
      drift_limit: if set, a later window's TTFT p99 exceeding
        ``drift_limit`` times the first window's is a violation.
      spot_check: number of request ids (sampled deterministically from
        the seed) to re-serve alone, unpadded, and bit-compare.  Runs
        only on exact continuous pools (``quality=None``) under a
        non-tier-switching policy — see the module docstring for why
        approx/switched tiers have no cross-batch oracle; skipped
        checks report as ``spot_checks == 0``.
      progress: optional callback invoked with each :class:`WindowAudit`.
      loop: ``"closed"`` (legacy queue drain) or ``"open"`` — each
        window's arrival clocks (rebased to the window start) gate
        admission, measuring queue delay and backpressure.  Continuous
        scheduler only.
      policy: admission policy name or instance for the continuous
        scheduler (see :mod:`repro_torch.serve.policy`); per-run state resets
        at every window boundary, so each window is one deterministic
        policy episode.
      step_time_s, clock: the open-loop clock (see
        :meth:`ContinuousScheduler.run`); the default virtual clock
        makes every soak timing deterministic.
      strategy: decode strategy name or instance for the continuous
        scheduler (see :mod:`repro_torch.serve.strategy`).  ``None`` keeps the
        default greedy rounds; ``"speculative"`` self-speculates, and
        since speculative output bit-matches plain decode the parity
        spot-checks against the static oracle remain valid verbatim.
        Workload traces with a ``spec_fraction`` (churn/bursty presets)
        tag a fraction of requests, so a speculative soak exercises
        mid-stream strategy switching as tagged rows come and go.
    """
    if scheduler not in ("continuous", "static"):
        raise ValueError(f"scheduler must be continuous|static, got {scheduler!r}")
    if loop not in ("closed", "open"):
        raise ValueError(f"loop must be closed|open, got {loop!r}")
    if loop == "open" and scheduler != "continuous":
        raise ValueError("open-loop soak requires the continuous scheduler")
    if spot_check < 0:
        raise ValueError(f"spot_check must be >= 0, got {spot_check}")
    if scheduler == "static" and strategy not in (None, "greedy"):
        raise ValueError("decode strategies require the continuous scheduler")
    pol: Optional[AdmissionPolicy] = (
        get_policy(policy) if policy is not None else None
    )
    if spec.eos_probe and spec.eos_id is None:
        spec = dataclasses.replace(
            spec, eos_id=probe_eos_id(model, params, spec, seed=seed,
                                      quality=quality),
        )

    # a tier-switching policy serves sampled requests at pressure-dependent
    # tiers, so the unpadded static oracle is only valid under static
    # admission on an exact pool
    static_admission = pol is None or isinstance(pol, StaticTier)
    sample_ids: set = set()
    if (spot_check and scheduler == "continuous" and quality is None
            and static_admission):
        picker = np.random.default_rng(seed + 1)
        sample_ids = set(
            int(i) for i in picker.choice(
                spec.requests, size=min(spot_check, spec.requests), replace=False
            )
        )
    sampled: dict = {}  # id -> (Request, np.ndarray soak stream)

    sched = None
    if scheduler == "continuous":
        sched = ContinuousScheduler(
            model, params, batch_size=batch_size, prompt_len=spec.prompt_len,
            max_new=spec.max_new, quality=quality, strategy=strategy,
        )
        sched.warmup()
        pool_tier = sched.quality
    else:
        pool_tier = _apply_pool_quality(model, quality)[1]

    served_ids: set = set()
    windows: list[WindowAudit] = []
    violations: list[str] = []
    retirement_order: list[int] = []
    slot_reuse: Optional[list] = None

    for k, (window_reqs, times) in enumerate(iter_windows(spec, seed, window_size)):
        if scheduler == "continuous":
            if loop == "open":
                # window arrivals rebased to the window start: each window
                # is a self-contained open-loop episode
                arrivals = [t - times[0] for t in times]
                result = sched.run(
                    window_reqs, warmup=False, arrivals_s=arrivals,
                    policy=pol, step_time_s=step_time_s, clock=clock,
                )
            else:
                result = sched.run(window_reqs, warmup=False, policy=pol)
        else:
            result = static_serve_loop(
                model, params, window_reqs, batch_size=batch_size,
                prompt_len=spec.prompt_len, gen=spec.max_new,
                warmup=(k == 0), quality=quality,
            )
        audit = _audit_window(k, window_reqs, times, result, served_ids)
        windows.append(audit)
        violations.extend(audit.violations)
        retirement_order.extend(rs.id for rs in result.request_stats)
        acct = result.accounting
        if acct.slot_reuse:
            if slot_reuse is None:
                slot_reuse = [0] * len(acct.slot_reuse)
            for i, n in enumerate(acct.slot_reuse):
                slot_reuse[i] += n
        for req in window_reqs:
            if req.id in sample_ids and req.id in result.outputs:
                sampled[req.id] = (req, result.outputs[req.id])
        if progress is not None:
            progress(audit)

    # tail-latency drift: later windows against the first window's p99
    drift = 1.0
    baselines = [w.ttft_p99_s for w in windows if w.ttft_p99_s is not None]
    if len(baselines) > 1 and baselines[0] > 0:
        drift = max(p / baselines[0] for p in baselines[1:])
        if drift_limit is not None and drift > drift_limit:
            violations.append(
                f"ttft p99 drift {drift:.2f}x exceeds limit {drift_limit:.2f}x"
            )

    # parity spot-checks: the sampled soak streams must bit-match the same
    # request served alone, unpadded, through the static oracle
    failures = 0
    for rid in sorted(sampled):
        req, stream = sampled[rid]
        alone = static_serve_loop(
            model, params, [req], batch_size=1, prompt_len=req.prompt_len,
            gen=req.max_new, warmup=False, quality=quality,
        )
        want = np.asarray(alone.outputs[rid])
        if not np.array_equal(want, stream):
            failures += 1
            # where the streams part, and how near a tie the oracle's
            # greedy choices were up to there (its own logits, teacher forced)
            got = np.asarray(stream)
            n = min(len(got), len(want))
            diff = np.flatnonzero(got[:n] != want[:n])
            j = int(diff[0]) if len(diff) else n
            gaps = teacher_gaps(model, params, req, want)[:j + 1]
            violations.append(
                f"spot-check: request {rid} soak stream diverged from the "
                f"unpadded single-request oracle at step {j} (top-2 logit gap "
                f"there {gaps[-1]:.6g}, least up to it {min(gaps):.6g})"
            )

    return SoakReport(
        workload=spec.name,
        arrival=spec.arrival,
        tier_mix=tier_mix_label(spec.tier_mix),
        scheduler=scheduler,
        quality=pool_tier or "",
        seed=seed,
        requests=spec.requests,
        batch_size=batch_size,
        window_size=window_size,
        windows=tuple(windows),
        retirement_order=tuple(retirement_order),
        slot_reuse=tuple(slot_reuse or ()),
        ttft_drift_p99=drift,
        drift_limit=drift_limit,
        spot_checks=len(sampled),
        spot_check_failures=failures,
        violations=tuple(violations),
        loop=loop,
        policy=pol.name if pol is not None else "",
        strategy=sched.strategy.name if sched is not None else "",
    )
