"""Serving the recurrent families through the port, against the JAX package's schedulers.

Reduced mamba2-130m (SSD) and recurrentgemma-2b (RG-LRU and local MQA
attention, four layers: one scanned group and one remainder) are served in
both packages from the reference's parameters: the continuous scheduler
on prompts of the bucket's full length (the recurrent state takes every
token in, so padded admission is refused, in both packages), and the
static loop, at the ``exact`` and ``balanced`` tiers.  The greedy streams
must be equal, after the near-tie guard of ``test_torch_serve.py``
(every greedy choice's top-2 logit gap above ``MARGIN``), and so must the
stats the two schedulers count alike.

The reference resolves ``balanced`` through a static auditor that raises
under this jax version; the module fixture replaces it, in this process
only, by the port's static certifier after checking that both
packages then resolve every tier alike (ROADMAP.md section 3).

Then the refusals: padded admission (the port's copy of
``tests/test_serve_scheduler.py``'s), self-speculative decoding, and the
serve CLI auto-selecting the static loop for both families.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
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
from repro_torch.analysis import audit as port_audit
from repro_torch import serve
from repro_torch.configs.registry import get_config
from repro_torch.engine import config as engine_config
from repro_torch.models.registry import build_model, from_jax_params
from repro_torch.serve.scheduler import has_recurrent_state

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROMPT, GEN, BATCH = 8, 5, 3
MARGIN = 1e-4
TIERS = ("high", "balanced", "draft")
ARCHS = ("mamba2-130m", "recurrentgemma-2b")


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
    """arch -> (jmodel, jparams, tmodel, tparams) at reduced(num_layers=4),
    each built once for the module."""
    built = {}

    def pools_of(arch):
        if arch not in built:
            jcfg = jax_get_config(arch).reduced(num_layers=4)
            tcfg = get_config(arch).reduced(num_layers=4)
            jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
            jparams = jmodel.init_params(jax.random.PRNGKey(0))
            tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                      device="cpu")
            built[arch] = jmodel, jparams, tmodel, tparams
        return built[arch]

    return pools_of


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


def _queue(pkg, quality, seed):
    """Seven full-length prompts (the bucket's width), budgets in [1, GEN]."""
    return pkg.synth_requests(7, prompt_len=PROMPT, gen=GEN, vocab_size=256, seed=seed,
                              min_prompt=PROMPT, quality=quality)


def _equal_streams(got, want, margins):
    assert min(margins.seen) > MARGIN, "a greedy near-tie: streams may differ legitimately"
    assert sorted(got.outputs) == sorted(want.outputs)
    for rid, stream in got.outputs.items():
        np.testing.assert_array_equal(stream, want.outputs[rid], err_msg=f"request {rid}")
    assert dataclasses.astuple(got.accounting) == dataclasses.astuple(want.accounting)
    assert [(r.id, r.tokens_out, r.finish_reason) for r in got.request_stats] == [
        (r.id, r.tokens_out, r.finish_reason) for r in want.request_stats]


@pytest.mark.parametrize("quality", ["exact", "balanced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_streams_equal_the_reference(pools, arch, quality):
    """The continuous scheduler on full-length prompts, rows admitted and
    retired at different rounds (budgets drawn in [1, GEN]): the streams and
    the slot accounting equal the reference scheduler's."""
    jmodel, jparams, tmodel, tparams = pools(arch)
    shape = dict(batch_size=BATCH, prompt_len=PROMPT, max_new=GEN, quality=quality)
    queue = _queue(serve, quality, seed=8)
    assert all(r.prompt_len == PROMPT for r in queue) and len({r.max_new for r in queue}) > 1
    want = jax_serve.ContinuousScheduler(jmodel, jparams, **shape).run(
        _queue(jax_serve, quality, seed=8), warmup=False)
    with _Margins(tparams) as margins:
        got = serve.ContinuousScheduler(tmodel, tparams, **shape).run(queue, warmup=False)
    _equal_streams(got, want, margins)
    for field in ("requests", "tokens_out", "decode_steps", "slot_utilization", "quality"):
        assert getattr(got.stats, field) == getattr(want.stats, field), field


@pytest.mark.parametrize("quality", ["exact", "balanced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_static_loop_streams_equal_the_reference(pools, arch, quality):
    """The static loop (whose batches may mix budgets; its warmup runs the
    padded dummy batch the reference runs) equals the reference's."""
    jmodel, jparams, tmodel, tparams = pools(arch)
    shape = dict(batch_size=BATCH, prompt_len=PROMPT, gen=GEN, quality=quality)
    want = jax_serve.static_serve_loop(jmodel, jparams, _queue(jax_serve, quality, seed=9),
                                       warmup=False, **shape)
    with _Margins(tparams) as margins:
        got = serve.static_serve_loop(tmodel, tparams, _queue(serve, quality, seed=9), **shape)
    _equal_streams(got, want, margins)
    for field in ("requests", "tokens_out", "decode_steps", "slot_utilization", "quality",
                  "scheduler"):
        assert getattr(got.stats, field) == getattr(want.stats, field), field


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_family_rejects_padded_admission(pools, arch):
    """RG-LRU / SSD state integrates left pads (positions cannot mask it),
    so padded admission raises, as in the reference; full-length prompts
    serve, the warmup included (its admission is full-length here)."""
    _, _, model, params = pools(arch)
    assert has_recurrent_state(model.cfg) and not serve.supports_continuous(model.cfg)
    rng = np.random.default_rng(0)
    short = serve.Request(id=0, tokens=rng.integers(0, 256, 4).astype(np.int32), max_new=2)
    with pytest.raises(ValueError, match="recurrent-state"):
        serve.continuous_serve_loop(model, params, [short], batch_size=1, prompt_len=8,
                                    max_new=2, warmup=False)
    full = serve.Request(id=1, tokens=rng.integers(0, 256, 8).astype(np.int32), max_new=2)
    res = serve.continuous_serve_loop(model, params, [full], batch_size=2, prompt_len=8,
                                      max_new=2)
    assert res.stats_for(1).tokens_out == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_self_speculative_refuses_recurrent_state(pools, arch):
    """A verify forward writes k + 1 steps into state no rollback undoes:
    ``SelfSpeculative`` refuses the pool and names ROADMAP; greedy serves it."""
    _, _, model, params = pools(arch)
    with pytest.raises(ValueError, match="ROADMAP"):
        serve.ContinuousScheduler(model, params, batch_size=2, prompt_len=PROMPT, max_new=GEN,
                                  strategy=serve.SelfSpeculative(k=2))
    serve.ContinuousScheduler(model, params, batch_size=2, prompt_len=PROMPT, max_new=GEN,
                              strategy="greedy")


def _run(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=300)


@pytest.mark.parametrize("arch,tier", [("mamba2-130m", None), ("recurrentgemma-2b", "balanced")])
def test_cli_auto_selects_the_static_loop(arch, tier):
    tier_args = ["--quality-tier", tier] if tier else []
    proc = _run("-m", "repro_torch.launch.serve", "--arch", arch, "--reduced", "--device", "cpu",
                "--requests", "4", "--batch", "2", "--gen", "4", *tier_args)
    assert proc.returncode == 0, proc.stderr
    assert f"# {arch}-smoke: auto-selected --scheduler static" in proc.stdout
    assert "[static] served 4 requests, 16 tokens" in proc.stdout
