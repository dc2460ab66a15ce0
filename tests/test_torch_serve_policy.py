"""The port's open loop, admission policies and static loop against the JAX package's.

On the virtual clock, and with no request carrying an EOS, the schedule of
an open-loop run does not depend on the model: every admission and decode
step advances the clock by ``step_time_s`` times the serving tier's cycle
factor, and the policies decide from queue depths and from TTFTs that the
clock alone sets.  So for the same seeded trace the port must reproduce
the reference's switch sequence, per-request ``ttft_s``,
``queue_delay_s``, ``latency_s`` and served tier, and the rejected ids,
exactly, whatever tiers the ladder holds.  The token streams must be equal
too where every tier is deterministic (``draft`` draws torch noise, not
jax noise), after the near-tie guard of ``test_torch_serve.py``.  The
static loop's streams must equal the reference's.  Then both CLIs' new
paths run on the CPU.

The reference resolves ``high``/``balanced``/``draft`` through a static
auditor that raises under this jax version; the module fixture replaces
it, in this process only, by the port's integer-envelope stand-in after
checking that both packages then resolve every tier alike.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.analysis.audit as jax_audit
from repro import serve as jax_serve
from repro.configs.registry import get_config as jax_get_config
from repro.engine import config as jax_engine_config
from repro.models.registry import build_model as jax_build_model
from repro.serve import workload as jax_wl
from repro_torch import serve
from repro_torch.configs.registry import get_config
from repro_torch.engine import config as engine_config
from repro_torch.models.registry import build_model, from_jax_params
from repro_torch.serve import workload as wl

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROMPT, GEN, BATCH = 8, 6, 4
MARGIN = 1e-4
TIERS = ("high", "balanced", "draft")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: at these sizes it is faster than many, and it
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def certifier_stub():
    """The reference's tier certifier, replaced by the port's stand-in for
    this module; both packages must then resolve every tier alike."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_audit, "certified",
                   lambda mode, n, t: engine_config.within_envelope(mode, n, t))
        for tier in TIERS:
            want = jax_engine_config.resolve_tier(tier)
            got = engine_config.resolve_tier(tier)
            assert [(q.target, q.n, q.t, q.mode) for q in got.per_target] == [
                (q.target, q.n, q.t, q.mode) for q in want.per_target], tier
        yield
    # nothing computed under the stand-in outlives this module
    jax_engine_config.tier_cycle_factor.cache_clear()
    jax_engine_config.accept_rate_estimate.cache_clear()


@pytest.fixture(scope="module")
def pools():
    jcfg, tcfg = jax_get_config("qwen3-0.6b").reduced(), get_config("qwen3-0.6b").reduced()
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, tmodel, tparams


def _policies(pkg, name):
    return {
        "static": lambda: pkg.StaticTier(),
        "reject": lambda: pkg.Reject(max_queue_depth=3),
        "slo-adaptive": lambda: pkg.SLOAdaptive(slo_ttft_s=0.05, degrade_after=2,
                                                recover_after=4, min_dwell_ticks=4),
        "slo-adaptive high+balanced": lambda: pkg.SLOAdaptive(
            slo_ttft_s=0.05, ladder=("high", "balanced"), degrade_after=2, recover_after=4,
            min_dwell_ticks=4),
        # queue-driven only (the TTFT target is out of reach): degrades in the
        # burst, recovers in the quiet tail
        "slo-adaptive burst+quiet": lambda: pkg.SLOAdaptive(
            slo_ttft_s=100.0, degrade_after=2, recover_after=3, min_dwell_ticks=3),
    }[name]()


def _trace(pkg_wl, policy: str):
    """(requests, arrivals): a seeded bursty draw, or 20 requests at t = 0
    followed by a widely spaced tail."""
    if policy.endswith("burst+quiet"):
        queue = serve.synth_requests(32, prompt_len=PROMPT, gen=GEN, vocab_size=256, seed=17,
                                     vary_budget=False)
        return queue, [0.0] * 20 + [2.0 + 0.3 * i for i in range(12)]
    spec = pkg_wl.preset_spec("bursty", requests=40, prompt_len=PROMPT, max_new=GEN,
                              vocab_size=256, rate_rps=256.0, slo_ttft_s=0.05)
    draw = pkg_wl.generate(spec, seed=0)
    return list(draw.requests), list(draw.arrivals_s)


def _record(rs) -> tuple:
    return (rs.id, rs.ttft_s, rs.queue_delay_s, rs.latency_s, rs.arrival_s, rs.tier_served,
            rs.admit_step, rs.tokens_out, rs.finish_reason)


def _switches(result) -> list:
    return [(s.step, s.now_s, s.from_tier, s.to_tier, s.reason) for s in result.tier_switches]


class _Margins:
    """Records the smallest top-2 logit margin of every greedy choice."""

    def __init__(self, params):
        self.params, self.seen = params, []

    def __enter__(self):
        lm_head = self.params.lm_head

        def recording(hidden):
            logits = lm_head(hidden)
            top2 = torch.topk(logits, 2, dim=-1).values
            self.seen.append(float((top2[..., 0] - top2[..., 1]).min()))
            return logits

        self.params.lm_head = recording
        return self

    def __exit__(self, *exc):
        del self.params.lm_head


@pytest.mark.parametrize("policy", ["static", "reject", "slo-adaptive",
                                    "slo-adaptive high+balanced", "slo-adaptive burst+quiet"])
def test_open_loop_schedule_equals_the_reference(pools, policy):
    jmodel, jparams, tmodel, tparams = pools
    quality = "high" if policy.startswith("slo") else None
    (jreqs, jarrivals), (reqs, arrivals) = _trace(jax_wl, policy), _trace(wl, policy)
    want = jax_serve.ContinuousScheduler(
        jmodel, jparams, batch_size=BATCH, prompt_len=PROMPT, max_new=GEN, quality=quality,
    ).run(jreqs, warmup=False, arrivals_s=jarrivals, policy=_policies(jax_serve, policy),
          step_time_s=0.01)
    with _Margins(tparams) as margins:
        got = serve.ContinuousScheduler(
            tmodel, tparams, batch_size=BATCH, prompt_len=PROMPT, max_new=GEN, quality=quality,
        ).run(reqs, warmup=False, arrivals_s=arrivals, policy=_policies(serve, policy),
              step_time_s=0.01)
    assert _switches(got) == _switches(want)
    assert [_record(r) for r in got.request_stats] == [_record(r) for r in want.request_stats]
    assert [_record(r) for r in got.rejected] == [_record(r) for r in want.rejected]
    for field in ("requests", "tokens_out", "decode_steps", "slot_utilization", "open_loop",
                  "policy", "queue_delay_s", "ttft_s", "tier_switches", "rejected", "starved",
                  "slo_total", "slo_attained", "modeled_cost"):
        assert getattr(got.stats, field) == getattr(want.stats, field), field
    assert dataclasses.astuple(got.accounting) == dataclasses.astuple(want.accounting)
    st = got.stats
    assert st.open_loop and st.starved == 0
    if policy == "reject":
        assert st.rejected > 0 and st.requests + st.rejected == len(reqs)
    reasons = [s[-1] for s in _switches(got)]
    if policy.startswith("slo"):
        assert any(r.startswith("degrade:") for r in reasons)
    if policy.endswith("burst+quiet"):
        assert "recover" in reasons and "draft" in {r.tier_served for r in got.request_stats}
    if "draft" not in {r.tier_served for r in got.request_stats}:  # deterministic tiers only
        assert min(margins.seen) > MARGIN, "a greedy near-tie: streams may differ legitimately"
        assert sorted(got.outputs) == sorted(want.outputs)
        for rid, stream in got.outputs.items():
            np.testing.assert_array_equal(stream, want.outputs[rid], err_msg=f"request {rid}")


def test_wall_clock_and_validation(pools):
    _, _, tmodel, tparams = pools
    reqs, arrivals = _trace(wl, "slo-adaptive")
    reqs, arrivals = reqs[:6], [a - arrivals[0] for a in arrivals[:6]]
    sched = serve.ContinuousScheduler(tmodel, tparams, batch_size=2, prompt_len=PROMPT,
                                      max_new=GEN)
    res = sched.run(reqs, warmup=False, arrivals_s=arrivals, clock="wall")
    assert res.stats.requests == 6 and res.stats.open_loop
    assert all(r.queue_delay_s >= 0 and r.ttft_s >= r.queue_delay_s for r in res.request_stats)
    with pytest.raises(ValueError, match="entries"):
        sched.run(reqs, arrivals_s=[0.0], warmup=False)
    with pytest.raises(ValueError, match="non-decreasing"):
        sched.run(reqs[:2], arrivals_s=[1.0, 0.0], warmup=False)
    with pytest.raises(ValueError, match="clock"):
        sched.run(reqs[:2], arrivals_s=[0.0, 0.0], clock="sundial", warmup=False)
    with pytest.raises(ValueError, match="step_time_s"):
        sched.run(reqs[:2], arrivals_s=[0.0, 0.0], step_time_s=0.0, warmup=False)


def test_policy_units_match_the_reference():
    assert sorted(serve.policy.POLICIES) == sorted(jax_serve.policy.POLICIES)
    pol, ref = serve.SLOAdaptive(slo_ttft_s=0.05), jax_serve.SLOAdaptive(slo_ttft_s=0.05)
    assert pol.ladder == ref.ladder
    for rung in range(len(pol.ladder)):
        pol._rung = ref._rung = rung
        assert pol.speculation(None) == ref.speculation(None)
    # the same synthetic ticks drive both state machines through the same switches
    pol, ref = (pkg.SLOAdaptive(slo_ttft_s=1.0, degrade_after=2, recover_after=3,
                                min_dwell_ticks=2) for pkg in (serve, jax_serve))
    for p, snap_cls in ((pol, serve.LoadSnapshot), (ref, jax_serve.LoadSnapshot)):
        p.begin("high")
        for i, depth in enumerate([20, 20, 20, 20, 20, 0, 0, 0, 0, 0, 0, 0, 0]):
            p.tier(snap_cls(now_s=0.01 * i, step=i, queue_depth=depth, pending=0,
                            live_rows=4, batch_size=4))
    assert [(s.step, s.from_tier, s.to_tier, s.reason) for s in pol.switches] == [
        (s.step, s.from_tier, s.to_tier, s.reason) for s in ref.switches]
    assert len(pol.switches) >= 3
    rej = serve.Reject(max_queue_depth=3)
    assert rej.admit(None, serve.LoadSnapshot(0.0, 0, 3, 0, 2, 2))
    assert not rej.admit(None, serve.LoadSnapshot(0.0, 0, 4, 0, 2, 2))
    for bad in (dict(ladder=("high",)), dict(slo_ttft_s=0), dict(spec_k=0),
                dict(ladder=("high", "nope"))):
        with pytest.raises(ValueError):
            serve.SLOAdaptive(**bad)


@pytest.mark.parametrize("quality", [None, "balanced"])
def test_static_serve_loop_streams_equal_the_reference(pools, quality):
    jmodel, jparams, tmodel, tparams = pools
    queue = serve.synth_requests(7, prompt_len=PROMPT, gen=GEN, vocab_size=256, seed=4,
                                 quality=quality)
    want = jax_serve.static_serve_loop(jmodel, jparams, queue, batch_size=3,
                                       prompt_len=PROMPT, gen=GEN, quality=quality,
                                       warmup=False)
    with _Margins(tparams) as margins:
        got = serve.static_serve_loop(tmodel, tparams, queue, batch_size=3,
                                      prompt_len=PROMPT, gen=GEN, quality=quality)
    assert min(margins.seen) > MARGIN, "a greedy near-tie: streams may differ legitimately"
    for r in queue:
        np.testing.assert_array_equal(got.outputs[r.id], want.outputs[r.id],
                                      err_msg=f"request {r.id}")
    for field in ("requests", "tokens_out", "decode_steps", "slot_utilization", "quality",
                  "scheduler"):
        assert getattr(got.stats, field) == getattr(want.stats, field), field
    assert dataclasses.astuple(got.accounting) == dataclasses.astuple(want.accounting)
    assert [(r.id, r.tokens_out, r.finish_reason) for r in got.request_stats] == [
        (r.id, r.tokens_out, r.finish_reason) for r in want.request_stats]
    assert serve.supports_continuous(tmodel.cfg)


def _run(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=300)


def test_cli_open_loop_slo_adaptive_on_the_cpu():
    proc = _run("-m", "repro_torch.launch.serve", "--arch", "qwen3-0.6b", "--reduced",
                "--device", "cpu", "--loop", "open", "--workload", "bursty", "--policy",
                "slo-adaptive", "--slo-ttft-ms", "50", "--requests", "32", "--batch", "4",
                "--gen", "8", "--prompt-len", "8")
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "# open loop: bursty preset" in out and "policy slo-adaptive" in out
    assert re.search(r"served 32 requests, \d+ tokens", out), out
    assert re.search(r"# tier switch @ step \d+ t=[\d.]+s: high -> balanced", out), out


def test_cli_speculative_and_static_on_the_cpu():
    proc = _run("-m", "repro_torch.launch.serve", "--arch", "qwen3-0.6b", "--reduced",
                "--device", "cpu", "--strategy", "speculative", "--spec-k", "3",
                "--draft-tier", "balanced", "--requests", "4", "--batch", "2", "--gen", "6",
                "--prompt-len", "8")
    assert proc.returncode == 0, proc.stderr
    assert "# speculative: k=3 draft=balanced verify=exact" in proc.stdout
    assert re.search(r"# speculative accept: \d+/\d+ draft tokens", proc.stdout), proc.stdout
    assert "served 4 requests, 24 tokens" in proc.stdout
    proc = _run("-m", "repro_torch.launch.serve", "--arch", "qwen3-0.6b", "--reduced",
                "--device", "cpu", "--scheduler", "static", "--requests", "5", "--batch", "2",
                "--gen", "4", "--prompt-len", "8")
    assert proc.returncode == 0, proc.stderr
    assert "[static] served 5 requests, 20 tokens" in proc.stdout
