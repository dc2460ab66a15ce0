"""The port's soak harness against the JAX package's.

``run_soak`` streams a seeded workload through the scheduler window by
window and audits slot conservation, per-row write positions, bounded
outputs, tail drift and parity spot-checks.  On reduced ``qwen3-0.6b`` with
the JAX model's parameters converted by ``from_jax_params``, the port's
``summary_row`` must equal the live reference's field by field, save the
fields that read the wall clock, for ``steady`` and for ``churn`` (whose
EOS id is probed from the pool's greedy first tokens); and the four rows
of ``benchmarks/baselines/BENCH_serve_soak.json`` that resolve no tier
must match the port in every field the schedule sets.

The reference resolves ``high``/``balanced``/``draft`` through a static
auditor that raises under this jax version; the module fixture replaces
it, in this process only, by the port's static certifier after
checking that both packages then resolve every tier alike.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.analysis.audit as jax_audit
from repro.configs.registry import get_config as jax_get_config
from repro.engine import config as jax_engine_config
from repro.models.registry import build_model as jax_build_model
from repro.serve import soak as jax_soak
from repro.serve import workload as jax_wl
from repro_torch.analysis import audit as port_audit
from repro_torch.configs.registry import get_config
from repro_torch.engine import config as engine_config
from repro_torch.models.registry import build_model, from_jax_params
from repro_torch.serve import soak
from repro_torch.serve import workload as wl

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIERS = ("high", "balanced", "draft")
# summary_row fields read from the wall clock (closed-loop TTFTs included)
WALL = {"wall_s", "tokens_per_s", "ttft_p50_s", "ttft_p99_s_worst", "ttft_p999_s_worst",
        "ttft_drift_p99"}
# the fields of a BENCH_serve_soak row that the schedule alone sets
SCHEDULED = ("requests", "batch_size", "window_size", "window_count", "tokens_out",
             "decode_steps", "slot_utilization", "seated", "retired", "slot_leaks",
             "position_violations", "lost_requests", "duplicate_serves", "max_live",
             "reuse_spread", "rejected", "eos_retired", "tier_switches", "spot_checks",
             "spot_check_failures", "violation_count", "invariants_ok")


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
    """The reference's tier certifier, replaced by the port's certifier
    (``repro_torch.analysis.audit.certified``) for this module; both
    packages must then resolve every tier alike at n = 8."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_audit, "certified", port_audit.certified)
        for tier in TIERS:
            want = jax_engine_config.resolve_tier(tier, n=8)
            got = engine_config.resolve_tier(tier, n=8)
            assert [(q.target, q.n, q.t, q.mode) for q in got.per_target] == [
                (q.target, q.n, q.t, q.mode) for q in want.per_target], tier
        yield
    # nothing computed under the port's certifier outlives this module
    jax_engine_config.tier_cycle_factor.cache_clear()
    jax_engine_config.accept_rate_estimate.cache_clear()


@pytest.fixture(scope="module")
def pools():
    jcfg, tcfg = jax_get_config("qwen3-0.6b").reduced(), get_config("qwen3-0.6b").reduced()
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, tmodel, tparams


# (preset, requests, seed, window, spot checks): churn at the size of its
# BENCH_serve_soak row, so that its EOS probe fires
CASES = [("steady", 64, 1, 32, 2), ("churn", 256, 0, 64, 3)]


@pytest.mark.parametrize("preset,requests,seed,window,spot", CASES, ids=["steady", "churn"])
def test_summary_row_equals_the_reference(pools, preset, requests, seed, window, spot):
    jmodel, jparams, tmodel, tparams = pools
    kw = dict(requests=requests, prompt_len=8, max_new=6, vocab_size=jmodel.cfg.vocab_size)
    run = dict(batch_size=4, seed=seed, window_size=window, drift_limit=50.0, spot_check=spot)
    want = jax_soak.run_soak(jmodel, jparams, jax_wl.preset_spec(preset, **kw), **run)
    got = soak.run_soak(tmodel, tparams, wl.preset_spec(preset, **kw), **run)
    row, ref = got.summary_row(), want.summary_row()
    assert sorted(row) == sorted(ref)
    for key in sorted(set(row) - WALL):
        assert row[key] == ref[key], key
    assert got.retirement_order == want.retirement_order
    assert got.slot_reuse == want.slot_reuse
    assert got.ok and row["spot_checks"] == spot and row["spot_check_failures"] == 0
    if preset == "churn":
        spec = wl.preset_spec(preset, **kw)
        assert soak.probe_eos_id(tmodel, tparams, spec, seed=seed) == jax_soak.probe_eos_id(
            jmodel, jparams, jax_wl.preset_spec(preset, **kw), seed=seed)
        assert row["eos_retired"] > 0


# what the churn row's EOS probe sets: the probed id comes from the weights'
# greedy tokens, and under this jax version the live reference itself
# retires other rows by EOS than the committed row (drawn with jax 0.4.37)
# does, so these fields of that row are held against the live reference
# (test_summary_row_equals_the_reference[churn]) and not the file
EOS_SET = ("tokens_out", "decode_steps", "slot_utilization", "reuse_spread", "eos_retired")


def test_baseline_rows_without_a_tier_match(pools):
    _, _, tmodel, tparams = pools
    baseline = json.loads((ROOT / "benchmarks/baselines/BENCH_serve_soak.json").read_text())
    rows = [r for r in baseline["rows"] if r["quality"] == ""]
    assert len(baseline["rows"]) == 6 and len(rows) == 4
    for want in rows:
        spec = wl.preset_spec(want["workload"], requests=want["requests"], prompt_len=8,
                              max_new=6, vocab_size=tmodel.cfg.vocab_size)
        report = soak.run_soak(
            tmodel, tparams, spec, batch_size=want["batch_size"], seed=want["seed"],
            window_size=want["window_size"], scheduler=want["scheduler"],
            drift_limit=want["drift_limit"], spot_check=3, loop=want["loop"],
        )
        got = report.summary_row()
        for key in ("workload", "arrival", "tier_mix", "scheduler", "loop",
                    "policy") + SCHEDULED:
            if spec.eos_probe and key in EOS_SET:
                continue
            assert got[key] == want[key], (want["workload"], want["scheduler"], key)


def test_soak_validation_and_report(pools):
    _, _, tmodel, tparams = pools
    spec = wl.preset_spec("flood", requests=8, prompt_len=8, max_new=4, vocab_size=256)
    for bad, match in ((dict(scheduler="paged"), "continuous|static"),
                       (dict(loop="ajar"), "closed|open"),
                       (dict(loop="open", scheduler="static"), "continuous"),
                       (dict(spot_check=-1), "spot_check"),
                       (dict(scheduler="static", strategy="speculative"), "continuous")):
        with pytest.raises(ValueError, match=match):
            soak.run_soak(tmodel, tparams, spec, batch_size=2, **bad)
    seen = []
    report = soak.run_soak(tmodel, tparams, spec, batch_size=2, window_size=4,
                           progress=seen.append, loop="open", policy="reject",
                           strategy="speculative")
    assert [w.index for w in seen] == [0, 1] and report.ok
    assert report.summary_row()["strategy"] == "speculative"
    assert "PASS" in report.describe()


def test_soak_cli_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.soak", "--arch", "qwen3-0.6b", "--reduced",
         "--device", "cpu", "--workload", "bursty", "--loop", "open", "--policy",
         "slo-adaptive", "--slo-ttft-ms", "50", "--requests", "48", "--batch", "4",
         "--prompt-len", "8", "--gen", "6", "--window", "24", "--spot-check", "2"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "# window    1: 24 reqs" in proc.stdout
    assert "[soak bursty/continuous] 48 requests in 2 windows of 24" in proc.stdout
    assert "PASS" in proc.stdout


def test_failed_spot_check_names_its_step_and_gap(pools, monkeypatch):
    """A sampled stream that parts from its unpadded oracle is reported with
    the step where they part and the oracle's top-2 logit gap there (its
    own logits, teacher forced), so a near tie shows in the violation."""
    _, _, tmodel, tparams = pools
    spec = wl.preset_spec("steady", requests=8, prompt_len=8, max_new=6, vocab_size=256)
    oracles = {}
    orig = soak.static_serve_loop

    def oracle_off_from_step_2(model, params, reqs, **kw):
        result = orig(model, params, reqs, **kw)
        if len(reqs) == 1:  # the spot-check's re-serve: change its stream from step 2 on
            out = np.array(result.outputs[reqs[0].id])
            out[2:] = (out[2:] + 1) % 256
            result.outputs[reqs[0].id] = oracles[reqs[0].id] = out
        return result

    monkeypatch.setattr(soak, "static_serve_loop", oracle_off_from_step_2)
    with torch.inference_mode():
        report = soak.run_soak(tmodel, tparams, spec, batch_size=4, window_size=8, spot_check=2)
    row = report.summary_row()
    assert row["spot_checks"] == row["spot_check_failures"] == 2 and not report.ok
    reqs = {r.id: r for r, _ in wl.iter_requests(spec, 0)}
    for rid, want in sorted(oracles.items()):
        gaps = soak.teacher_gaps(tmodel, tparams, reqs[rid], want)
        assert len(gaps) == len(want) and min(gaps) >= 0
        assert (f"spot-check: request {rid} soak stream diverged from the unpadded "
                f"single-request oracle at step 2 (top-2 logit gap there {gaps[2]:.6g}, least up to it "
                f"{min(gaps[:3]):.6g})") in report.violations
