"""Fault-tolerant training loop: checkpoint/restart, retry with backoff,
straggler detection, failure injection for tests.

The loop is deliberately host-side Python around a jitted step: that is
where production failures surface (XLA aborts, preempted workers raise
through the runtime, data feeds stall).  Recovery = restore the latest
complete checkpoint (possibly onto a *different* mesh — the checkpoint
manager re-shards) and replay from its step; the counter-based data
pipeline regenerates exactly the batches the failed run would have seen.

Straggler mitigation on a real fleet pairs this with the launcher's
slow-host eviction; here the monitor measures per-step wall time against
a running EMA and reports (and optionally calls back on) outliers —
the signal an orchestrator consumes to evict/replace a host.

The port's copy of ``repro/runtime/fault.py``, with two differences.  The
step runs eagerly on the card, so the loop waits for the device
(``torch.cuda.synchronize``) before it reads the step's time, where the
reference waits on the loss with ``block_until_ready``.  And the port's
step updates the parameters in place, so after a failure the loop first
waits for a checkpoint still being written and restores it: the
reference looks only at checkpoints already complete and otherwise
retries the step on the state it holds, which for the port may be a
state half updated.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

__all__ = ["StragglerMonitor", "FailureInjector", "run_loop", "LoopResult"]


class StragglerMonitor:
    """EMA-based step-time outlier detector."""

    def __init__(self, factor: float = 3.0, decay: float = 0.9, warmup: int = 3):
        self.factor = factor
        self.decay = decay
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.count = 0
        self.slow_steps: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.count += 1
        if self.ema is None:
            self.ema = dt
            return False
        slow = self.count > self.warmup and dt > self.factor * self.ema
        if slow:
            self.slow_steps.append((step, dt))
        else:  # don't pollute the EMA with outliers
            self.ema = self.decay * self.ema + (1 - self.decay) * dt
        return slow


class FailureInjector:
    """Deterministic failure schedule for integration tests."""

    def __init__(self, fail_at: tuple = ()):
        self.fail_at = set(fail_at)
        self.fired: set = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


def _wait(metrics: dict) -> None:
    """Wait for the device that computed ``metrics``, if it is a GPU."""
    for v in metrics.values():
        if torch.is_tensor(v) and v.device.type == "cuda":
            torch.cuda.synchronize(v.device)
            return


@dataclasses.dataclass
class LoopResult:
    state: Any
    metrics_history: list
    failures: int
    restarts: int
    slow_steps: list


def run_loop(
    state: Any,
    step_fn: Callable,
    batch_fn: Callable[[int], dict],
    *,
    total_steps: int,
    ckpt=None,
    checkpoint_every: int = 0,
    max_failures: int = 3,
    injector: Optional[FailureInjector] = None,
    monitor: Optional[StragglerMonitor] = None,
    log_every: int = 0,
    backoff_s: float = 0.0,
) -> LoopResult:
    """Run ``total_steps`` of ``step_fn`` with recovery.

    ``batch_fn(step)`` must be pure in ``step`` (counter-based pipeline).
    ``state.step`` (int32 scalar) is the authoritative position.
    """
    monitor = monitor or StragglerMonitor()
    history: list = []
    failures = restarts = 0

    if ckpt is not None and ckpt.latest_step() is not None:
        state, at = ckpt.restore(state)
        restarts += 1

    while int(state.step) < total_steps:
        step = int(state.step)
        try:
            if injector is not None:
                injector.maybe_fail(step)
            t0 = time.perf_counter()
            batch = batch_fn(step)
            state, metrics = step_fn(state, batch)
            _wait(metrics)
            dt = time.perf_counter() - t0
            monitor.record(step, dt)
            history.append({k: float(v) for k, v in metrics.items()})
            if log_every and step % log_every == 0:
                print(f"step {step:6d} loss {history[-1]['loss']:.4f} ({dt*1e3:.1f} ms)")
            if ckpt is not None and checkpoint_every and (step + 1) % checkpoint_every == 0:
                ckpt.save(step + 1, state)
        except Exception as e:  # noqa: BLE001 — recovery boundary
            failures += 1
            if failures > max_failures:
                raise RuntimeError(f"exceeded max_failures={max_failures}") from e
            if backoff_s:
                time.sleep(backoff_s * failures)
            if ckpt is not None:
                ckpt.wait()  # a save still in flight completes first
            if ckpt is not None and ckpt.latest_step() is not None:
                state, at = ckpt.restore(state)
                print(f"recovered from step {at} after: {e}")
            else:
                print(f"retrying step {step} after: {e}")
            restarts += 1

    if ckpt is not None:
        ckpt.wait()
    return LoopResult(state, history, failures, restarts, monitor.slow_steps)
