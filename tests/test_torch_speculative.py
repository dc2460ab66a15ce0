"""The port's self-speculative decoding against the JAX package's.

Three layers, on reduced ``qwen3-0.6b`` with the JAX model's parameters
converted by ``from_jax_params``:

* ``make_verify_step``: one ``(B, k+1)`` forward over live caches, per-row
  positions and write starts, a dead lane parked in the spare tail; the
  argmax is the reference's and the caches agree within the model
  tolerance (float32, ``rtol = atol = 1e-5``), at exact and at an explicit
  bitexact (n = 8, t = 4), where each approximate GEMM is handed the
  reference's input (``test_torch_model.py`` says why).
* ``SelfSpeculative`` in the port's scheduler: bit-equal to the port's
  greedy streams at exact verify (mixed lengths, admission mid-stream, EOS
  retirement, per-request tags), and equal to the live reference's streams
  for every draft tier, with equal ``spec_*`` counters for the
  deterministic ones (``exact``, ``balanced``, ``high``; ``draft`` draws
  torch noise, not jax noise).  A greedy choice whose top-2 logit margin
  is under 1e-4 could go either way between two programs that sum in
  another order, so every stream check first asserts that no such
  near-tie occurred at this seed.
* The speculation economics: equal to the reference's and to the four
  rows of ``benchmarks/baselines/BENCH_speculative.json``.

The reference resolves ``high``/``balanced``/``draft`` through a static
auditor that raises under this jax version; the module fixture replaces
it, in this process only, by the port's integer-envelope stand-in after
checking that both packages then resolve every tier alike.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.analysis.audit as jax_audit
import repro.models.layers as jax_layers
import repro_torch.models.layers as port_layers
from repro.configs.registry import apply_approx as jax_apply_approx
from repro.configs.registry import get_config as jax_get_config
from repro.engine import config as jax_engine_config
from repro.models.registry import build_model as jax_build_model
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import SelfSpeculative as JaxSelfSpeculative
from repro.serve.strategy import make_verify_step as jax_verify_step
from repro.train.steps import make_prefill_step as jax_prefill_step
from repro_torch.configs.registry import apply_approx, get_config
from repro_torch.engine import config as engine_config
from repro_torch.models.registry import build_model, from_jax_params
from repro_torch.serve import (
    ContinuousScheduler,
    GreedyDecode,
    Request,
    SelfSpeculative,
    get_strategy,
    synth_requests,
)
from repro_torch.serve.strategy import make_verify_step
from repro_torch.train.steps import make_prefill_step

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROMPT, GEN, BATCH = 8, 6, 2
MARGIN = 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)
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


def _convert(jcfg, tcfg):
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module")
def pools():
    return _convert(jax_get_config("qwen3-0.6b").reduced(), get_config("qwen3-0.6b").reduced())


class _Margins:
    """Records the smallest top-2 logit margin of every greedy choice the
    port's model makes while installed."""

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

    def assert_no_near_tie(self):
        assert min(self.seen) > MARGIN, "a greedy near-tie: the streams may differ legitimately"


def _jax_layer_caches(caches) -> list:
    """The reference's cache pytree as one (k, v) pair per layer."""
    if "rem" in caches:
        return [(np.asarray(c.k), np.asarray(c.v)) for c in caches["rem"]]
    (sub,) = caches["scan"].values()
    return [(np.asarray(k), np.asarray(v)) for k, v in zip(sub.k, sub.v)]


@pytest.mark.parametrize("approx", [None, ("bitexact", 8, 4)], ids=["exact", "bitexact-8-4"])
def test_verify_step_matches_reference(approx, monkeypatch):
    jcfg = jax_get_config("qwen3-0.6b").reduced(scan_layers=approx is None)
    tcfg = get_config("qwen3-0.6b").reduced()
    if approx is not None:
        mode, n, t = approx
        jcfg = jax_apply_approx(jcfg, mode=mode, n=n, t=t, targets=("mlp", "attn"))
        tcfg = apply_approx(tcfg, mode=mode, n=n, t=t, targets=("mlp", "attn"))
        recorded = []
        ref_2d, port_2d = jax_layers._approx_2d, port_layers._approx_2d

        def record(x2, w, ap, key):
            recorded.append(np.array(x2))
            return ref_2d(x2, w, ap, key)

        def forced(x2, w, ap, generator):
            want = recorded.pop(0)
            np.testing.assert_allclose(x2.numpy(), want, **TOL)
            return port_2d(torch.from_numpy(want), w, ap, generator)

        monkeypatch.setattr(jax_layers, "_approx_2d", record)
        monkeypatch.setattr(port_layers, "_approx_2d", forced)
    jmodel, jparams, tmodel, tparams = _convert(jcfg, tcfg)
    k, b = 3, 3
    cap = PROMPT + GEN + k
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (b, PROMPT)).astype(np.int32)
    pad = np.array([0, 3, 1])
    pos = (np.arange(PROMPT)[None, :] - pad[:, None]).astype(np.int32)
    jcache, _ = jax_prefill_step(jmodel, cap)(
        jparams, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
    with torch.inference_mode():
        tcache, _ = make_prefill_step(tmodel, cap)(
            tparams, {"tokens": torch.from_numpy(toks).long(),
                      "positions": torch.from_numpy(pos).long()})
    # rows 0 and 1 verify k+1 tokens at different depths (row 1 with a stale
    # suffix from an earlier window beyond its start); row 2 is a dead lane
    # parked at cap - (k + 1), causal at positions 0..k
    vtok = rng.integers(0, 256, (b, k + 1)).astype(np.int32)
    starts = np.array([PROMPT, PROMPT + 2, cap - (k + 1)], np.int32)
    first = np.array([pos[0, -1] + 1, pos[1, -1] + 3, 0], np.int32)
    vpos = (first[:, None] + np.arange(k + 1)[None, :]).astype(np.int32)
    before = [(c.k.clone(), c.v.clone()) for c in tcache]
    jver, jcache = jax_verify_step(jmodel)(jparams, jcache, jnp.asarray(vtok),
                                           jnp.asarray(vpos), jnp.asarray(starts))
    with torch.inference_mode():
        tver, tcache = make_verify_step(tmodel)(
            tparams, tcache, torch.from_numpy(vtok).long(), torch.from_numpy(vpos).long(),
            torch.from_numpy(starts).long())
    if approx is not None:
        assert not recorded
    np.testing.assert_array_equal(tver.numpy(), np.asarray(jver))
    for layer, ((jk, jv), c, (k0, v0)) in enumerate(
            zip(_jax_layer_caches(jcache), tcache, before, strict=True)):
        np.testing.assert_allclose(c.k.numpy(), jk, **TOL, err_msg=f"layer {layer} k")
        np.testing.assert_allclose(c.v.numpy(), jv, **TOL, err_msg=f"layer {layer} v")
        # each row wrote exactly its k+1 slots from its start: no clamp moved
        # the dead lane, and no row touched another's slots
        for row, s0 in enumerate(starts):
            keep = np.ones(cap, bool)
            keep[s0:s0 + k + 1] = False
            assert torch.equal(c.k[row, keep], k0[row, keep]), (layer, row)
            assert not torch.equal(c.k[row, ~keep], k0[row, ~keep]), (layer, row)


def _port_serve(tmodel, tparams, queue, strategy, **kw):
    sched = ContinuousScheduler(tmodel, tparams, batch_size=BATCH, prompt_len=PROMPT,
                                max_new=GEN, strategy=strategy, **kw)
    return sched, sched.run(queue, warmup=False)


def _assert_same_streams(got, want, queue):
    for r in queue:
        np.testing.assert_array_equal(got.outputs[r.id], want.outputs[r.id],
                                      err_msg=f"request {r.id}")


def _queue(case: str, tmodel, tparams):
    rng = np.random.default_rng(7)
    mk = lambda i, ln, budget, **kw: Request(
        id=i, tokens=rng.integers(0, 256, ln).astype(np.int32), max_new=budget, **kw)
    if case == "mixed lengths":
        return synth_requests(6, prompt_len=PROMPT, gen=GEN, vocab_size=256, seed=0)
    if case == "admission mid-stream":
        return [mk(0, 6, 2), mk(1, PROMPT, GEN), mk(2, 5, 2)]
    if case == "tags":
        return [mk(0, PROMPT, GEN, strategy="speculative"), mk(1, PROMPT, GEN),
                mk(2, 7, GEN), mk(3, PROMPT, GEN, strategy="speculative"),
                mk(4, PROMPT, GEN, strategy="greedy")]
    # EOS: a mid-stream greedy token of request 0 becomes every request's EOS
    prompts = [rng.integers(0, 256, PROMPT).astype(np.int32) for _ in range(4)]
    _, probe = _port_serve(tmodel, tparams, [Request(id=0, tokens=prompts[0], max_new=GEN)],
                           "greedy")
    eos = int(probe.outputs[0][GEN // 2])
    return [Request(id=i, tokens=p, max_new=GEN, eos_id=eos) for i, p in enumerate(prompts)]


@pytest.mark.parametrize("case", ["mixed lengths", "admission mid-stream", "eos", "tags"])
def test_speculative_bit_matches_greedy_at_exact_verify(pools, case):
    _, _, tmodel, tparams = pools
    queue = _queue(case, tmodel, tparams)
    with _Margins(tparams) as margins:
        _, plain = _port_serve(tmodel, tparams, queue, "greedy")
        sched, spec = _port_serve(tmodel, tparams, queue,
                                  SelfSpeculative(k=3, draft_tier="draft"))
    margins.assert_no_near_tie()
    _assert_same_streams(spec, plain, queue)
    assert sched.capacity == PROMPT + GEN + 3  # extra_capacity == k
    acc = spec.accounting
    assert acc.position_violations == 0 and acc.slot_leaks == 0
    assert spec.stats.spec_rounds > 0 and spec.stats.strategy == "speculative"
    for r in queue:
        assert spec.stats_for(r.id).finish_reason == plain.stats_for(r.id).finish_reason
    if case == "admission mid-stream":
        assert spec.stats_for(2).admit_step > 0
    if case == "eos":
        assert any(spec.stats_for(r.id).finish_reason == "eos" for r in queue)
    st = spec.stats
    assert st.spec_proposed == sum(rs.proposed for rs in spec.request_stats)
    assert st.spec_accepted == sum(rs.accepted for rs in spec.request_stats)
    assert st.spec_rolled_back == st.spec_proposed - st.spec_accepted
    assert "accept" in st.summary() and "[speculative]" in st.summary()


@pytest.mark.parametrize("draft", ["exact", "balanced", "high", "draft"])
def test_speculative_streams_and_counters_equal_the_reference(pools, draft):
    jmodel, jparams, tmodel, tparams = pools
    queue = synth_requests(6, prompt_len=PROMPT, gen=GEN, vocab_size=256, seed=3)
    want = JaxScheduler(jmodel, jparams, batch_size=BATCH, prompt_len=PROMPT, max_new=GEN,
                        strategy=JaxSelfSpeculative(k=3, draft_tier=draft)).run(
        queue, warmup=False)
    with _Margins(tparams) as margins:
        _, got = _port_serve(tmodel, tparams, queue, SelfSpeculative(k=3, draft_tier=draft))
    margins.assert_no_near_tie()
    _assert_same_streams(got, want, queue)
    assert got.stats.decode_steps > 0 and got.stats.spec_proposed > 0
    if draft != "draft":  # deterministic draft tiers propose what the reference proposes
        for field in ("decode_steps", "spec_rounds", "spec_proposed", "spec_accepted",
                      "modeled_cost", "tokens_out"):
            assert getattr(got.stats, field) == getattr(want.stats, field), field
        for a, b in zip(sorted(got.request_stats, key=lambda r: r.id),
                        sorted(want.request_stats, key=lambda r: r.id), strict=True):
            assert (a.id, a.proposed, a.accepted, a.admit_step) == (
                b.id, b.proposed, b.accepted, b.admit_step)
    if draft == "exact":
        assert got.stats.accept_rate == 1.0


def test_economics_equal_the_reference_and_the_baseline():
    pairs = [(d, v) for d in ("exact", *TIERS) for v in ("exact", *TIERS)]
    for d, v in pairs:
        assert engine_config.accept_rate_estimate(d, v) == jax_engine_config.accept_rate_estimate(
            d, v), (d, v)
        for k in (1, 3, 4):
            assert engine_config.speculation_gain(d, v, k) == jax_engine_config.speculation_gain(
                d, v, k), (d, v, k)
        assert engine_config.best_spec_k(d, v) == jax_engine_config.best_spec_k(d, v)
    for a, k in ((0.0, 1), (0.3, 4), (1.0, 3)):
        assert engine_config.expected_round_tokens(a, k) == (
            jax_engine_config.expected_round_tokens(a, k))
    with pytest.raises(ValueError):
        engine_config.expected_round_tokens(1.5, 2)
    with pytest.raises(ValueError):
        engine_config.best_spec_k("draft", "exact", k_max=0)
    baseline = json.loads((ROOT / "benchmarks/baselines/BENCH_speculative.json").read_text())
    assert len(baseline["rows"]) == 4
    for row in baseline["rows"]:
        d, v = row["draft_tier"], row["verify_tier"]
        best_k, best_gain = engine_config.best_spec_k(d, v)
        assert round(engine_config.accept_rate_estimate(d, v), 4) == row["accept_rate_est"]
        assert (best_k, round(best_gain, 4)) == (row["best_k_modeled"], row["best_gain_modeled"])


def test_strategy_registry_and_validation():
    assert isinstance(get_strategy(None), GreedyDecode)
    assert isinstance(get_strategy("speculative"), SelfSpeculative)
    inst = SelfSpeculative(k=2, draft_tier="draft")
    assert get_strategy(inst) is inst and inst.extra_capacity == 2
    with pytest.raises(ValueError, match="known: \\['greedy', 'speculative'\\]"):
        get_strategy("beam")
    with pytest.raises(ValueError, match="instance"):
        get_strategy(inst, k=3)
    with pytest.raises(ValueError):
        SelfSpeculative(k=0)
    with pytest.raises(ValueError, match="unknown quality tier"):
        SelfSpeculative(k=2, draft_tier="no-such-tier")
