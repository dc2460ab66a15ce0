"""The port's encoder-decoder (seamless-m4t-large-v2) against the JAX package.

``seamless-m4t-large-v2.reduced()`` (two encoder and two decoder layers,
4 query heads over 2 KV heads of 16, float32) is built in both packages,
and the JAX model's own parameters are loaded into the port with
``from_jax_params`` (the ``enc_scan`` and ``dec_scan`` stacks unstacked
per layer).  The same numpy frame embeddings and tokens, made from a
seed, go through both: ``encode`` (non-causal self-attention, through
the attention kernels' plain versions under ``attn_impl="pallas"``),
``precompute_cross``, ``decode_forward`` with the memory and with
precomputed cross K/V in the caches, ``Model.forward``, and the serving
pair: prefill (the encoder, the cross K/V cast to the cache dtype, the
decoder's causal prefill) and teacher-forced decode steps, at ``xla`` and
``pallas``, exact and ``bitexact`` on mlp and attn.  Everything within
``TOL`` (float32 sums in another order).  In the ``bitexact`` cases each
approximate GEMM of the port, and each approximate attention call's q, k
and v, is first checked to get the reference's input within ``TOL`` and
then fed the reference's input itself (``tests/test_torch_model.py``
says why).  The reference runs its stacked layers under ``lax.scan`` and
its serving steps under ``jax.jit``, so it records through ordered
``jax.debug.callback`` s.

Then the static loop, whose encoder memory both packages draw from
``np.random.default_rng(seed)`` in the same order (warmup batches
first): its token streams equal the reference's at ``exact`` and
``balanced``, after the near-tie guard of ``test_torch_serve.py``.  At
``balanced`` random frames put an input of the 8-bit quantizer across a
rounding boundary within a few calls, which moves logits by tenths: the
port's approximate GEMMs are fed the reference's inputs as above, and
must equal the reference's GEMM on them bit for bit; where the
reference's jitted GEMM differs from its own eager one (its compiled
quantizer rounds one element otherwise), the port's loop goes on from the
jitted output.  The
reference resolves ``balanced`` through a static auditor that raises
under this jax version; the module fixture replaces it, in this process
only, by the port's static certifier (as ``test_torch_recurrent_serve.py`` does).
Also: the loader's round trip and leaf order, the seeded init's scales,
the continuous scheduler's refusal and the serve CLI.
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
import jax.numpy as jnp

import repro.analysis.audit as jax_audit
import repro.kernels.approx_attention as jax_approx_attention
import repro.models.layers as jax_layers
import repro.serve.scheduler as jax_scheduler
from repro import serve as jax_serve
from repro.configs.registry import apply_approx as jax_apply_approx
from repro.configs.registry import get_config as jax_get_config
from repro.engine import config as jax_engine_config
from repro.models import encdec as jax_encdec
from repro.models.layers import Ctx as JaxCtx
from repro.models.registry import build_model as jax_build_model
from repro.train.steps import make_decode_step as jax_decode_step
from repro.train.steps import make_prefill_step as jax_prefill_step
from repro_torch.analysis import audit as port_audit
import repro_torch.models.attention as port_attention
import repro_torch.models.layers as port_layers
from repro_torch import serve
from repro_torch.configs.registry import apply_approx, get_config
from repro_torch.engine import config as engine_config
from repro_torch.models import encdec
from repro_torch.models.layers import Ctx
from repro_torch.models.registry import (
    build_model, from_jax_params, reference_leaves, to_jax_layout,
)
from repro_torch.train.steps import make_decode_step, make_prefill_step

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "seamless-m4t-large-v2"
TOL = dict(rtol=1e-5, atol=1e-5)
B, S, S_SRC, STEPS = 2, 9, 12, 3
PROMPT, GEN, BATCH = 8, 5, 3
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
    jax_engine_config.tier_cycle_factor.cache_clear()
    jax_engine_config.accept_rate_estimate.cache_clear()


def _pair(attn_impl="xla", approx=False):
    jcfg = jax_get_config(ARCH).reduced(attn_impl=attn_impl)
    tcfg = get_config(ARCH).reduced(attn_impl=attn_impl)
    if approx:
        kw = dict(mode="bitexact", n=8, t=4, targets=("mlp", "attn"))
        jcfg, tcfg = jax_apply_approx(jcfg, **kw), apply_approx(tcfg, **kw)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, tmodel, tparams


def _inputs(d_model, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, S_SRC, d_model)).astype(np.float32)
    toks = rng.integers(0, 256, (B, S + STEPS)).astype(np.int32)
    src_pos = np.broadcast_to(np.arange(S_SRC, dtype=np.int32), (B, S_SRC)).copy()
    return src, src_pos, toks


def _t(a):
    a = torch.from_numpy(np.ascontiguousarray(a))
    return a.long() if a.dtype == torch.int32 else a


def _force_reference_inputs(monkeypatch, *, jitted_outputs=False):
    """Record each approximate GEMM's input and each approximate attention
    call's q, k and v in the reference, and hand them to the port's
    matching call after checking the port's own.  The reference records
    through ordered ``jax.debug.callback`` s, so its scanned stacks and its
    jitted serving steps record in program order too.

    ``jitted_outputs``: the reference's jitted GEMM can differ from its own
    eager run on the same input by a quantum of a row (the compiled
    quantizer rounds an element to the other side).  Then the port's
    GEMM must equal the reference's eager GEMM on that input bit for bit,
    and the call returns the jitted output, so that the port's loop runs
    on from what the reference's loop saw."""
    recorded = []
    jax_2d, port_2d = jax_layers._approx_2d, port_layers._approx_2d
    jax_attn = jax_approx_attention.approx_flash_attention
    port_attn = port_attention.approx_flash_attention

    def keep(extra, *arrays):
        jax.debug.callback(
            lambda *a: recorded.append(tuple(np.array(x) for x in a) + extra), *arrays,
            ordered=True)

    def record(x2, w, ap, key):
        out = jax_2d(x2, w, ap, key)
        if jitted_outputs:
            keep((ap, key), x2, w, out)
        else:
            keep((), x2)
        return out

    def forced(x2, w, ap, generator):
        want, *rest = recorded.pop(0)
        np.testing.assert_allclose(x2.numpy(), want, **TOL)
        out = port_2d(torch.from_numpy(want), w, ap, generator)
        if not jitted_outputs:
            return out
        jw, jit_out, jap, key = rest
        eager = np.asarray(jax_2d(jnp.asarray(want), jnp.asarray(jw), jap, key))
        np.testing.assert_array_equal(out.numpy(), eager)
        return torch.from_numpy(jit_out)

    def record_attn(q, k, v, *args):
        keep((), q, k, v)
        return jax_attn(q, k, v, *args)

    def forced_attn(q, k, v, *args, **kw):
        want = recorded.pop(0)
        for got, w in zip((q, k, v), want):
            np.testing.assert_allclose(got.numpy(), w, **TOL)
        return port_attn(*(torch.from_numpy(w) for w in want), *args, **kw)

    monkeypatch.setattr(jax_layers, "_approx_2d", record)
    monkeypatch.setattr(port_layers, "_approx_2d", forced)
    monkeypatch.setattr(jax_approx_attention, "approx_flash_attention", record_attn)
    monkeypatch.setattr(port_attention, "approx_flash_attention", forced_attn)
    return recorded


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_encode_and_precompute_cross_match_reference(attn_impl):
    """The non-causal encoder (the flash forward's plain version, causal=False,
    under pallas) and each decoder layer's cross K/V from its memory."""
    jmodel, jparams, tmodel, tparams = _pair(attn_impl)
    src, src_pos, _ = _inputs(tmodel.cfg.d_model)
    jctx, tctx = JaxCtx(cfg=jmodel.cfg), Ctx(cfg=tmodel.cfg)
    jmem = jax_encdec.encode(jparams, jnp.asarray(src), jnp.asarray(src_pos), jctx)
    with torch.inference_mode():
        tmem = tmodel.encode(tparams, _t(src), _t(src_pos), tctx)
        tcross = tmodel.precompute_cross(tparams, tmem, tctx)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), **TOL)
    jk, jv = jax_encdec.precompute_cross(jparams, jmem, jctx)
    assert len(tcross) == tmodel.cfg.num_layers == jk.shape[0]
    for layer, (ck, cv) in enumerate(tcross):
        assert ck.shape == (B, S_SRC, tmodel.cfg.num_kv_heads, tmodel.cfg.head_dim)
        np.testing.assert_allclose(ck.numpy(), np.asarray(jk[layer]), **TOL)
        np.testing.assert_allclose(cv.numpy(), np.asarray(jv[layer]), **TOL)


def test_decode_forward_with_memory_and_with_caches_match_reference():
    """``decode_forward`` with the memory (training: cross K/V in each
    block) and with caches holding precomputed cross K/V (serving: the
    self KV caches written at slots [0, S)); the two give the same hidden
    states, and so does the reference each way."""
    jmodel, jparams, tmodel, tparams = _pair()
    cfg = tmodel.cfg
    src, src_pos, toks = _inputs(cfg.d_model, seed=1)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jctx, tctx = JaxCtx(cfg=jmodel.cfg), Ctx(cfg=cfg)
    jmem = jax_encdec.encode(jparams, jnp.asarray(src), jnp.asarray(src_pos), jctx)
    jh, _ = jax_encdec.decode_forward(jparams, jnp.asarray(toks[:, :S]), jnp.asarray(pos),
                                      jnp.asarray(src_pos), jctx, memory=jmem)
    jk, jv = jax_encdec.precompute_cross(jparams, jmem, jctx)
    jcaches = jax_encdec.init_dec_caches(jmodel.cfg, B, S + STEPS, S_SRC, jnp.float32)
    jcaches = jcaches._replace(cross_k=jk, cross_v=jv)
    jh2, jcaches = jax_encdec.decode_forward(
        jparams, jnp.asarray(toks[:, :S]), jnp.asarray(pos), jnp.asarray(src_pos), jctx,
        caches=jcaches, cache_pos=jnp.int32(0))
    with torch.inference_mode():
        tmem = tparams.encode(_t(src), _t(src_pos), tctx)
        th, none = tparams.decode_forward(_t(toks[:, :S]), _t(pos), _t(src_pos), tctx,
                                          memory=tmem)
        caches = encdec.init_dec_caches(cfg, B, S + STEPS, S_SRC, torch.float32, "cpu")
        caches = [c._replace(cross_k=ck, cross_v=cv)
                  for c, (ck, cv) in zip(caches, tparams.precompute_cross(tmem, tctx))]
        th2, caches = tparams.decode_forward(_t(toks[:, :S]), _t(pos), _t(src_pos), tctx,
                                             caches=caches, cache_pos=0)
    assert none is None
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(th2.numpy(), np.asarray(jh2), **TOL)
    np.testing.assert_allclose(th2.numpy(), th.numpy(), **TOL)
    for layer, cache in enumerate(caches):
        np.testing.assert_allclose(cache.self_kv.k.numpy(),
                                   np.asarray(jcaches.self_kv.k[layer]), **TOL)
        np.testing.assert_allclose(cache.self_kv.v.numpy(),
                                   np.asarray(jcaches.self_kv.v[layer]), **TOL)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_model_forward_matches_reference(attn_impl):
    """``Model.forward`` with ``src_embeds`` and ``src_pos`` (the training
    path): the hidden states, no caches, aux 0."""
    jmodel, jparams, tmodel, tparams = _pair(attn_impl)
    src, src_pos, toks = _inputs(tmodel.cfg.d_model, seed=2)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jh, jc, jaux = jmodel.forward(jparams, jnp.asarray(toks[:, :S]), jnp.asarray(pos),
                                  jmodel.ctx(), src_embeds=jnp.asarray(src),
                                  src_pos=jnp.asarray(src_pos))
    with torch.inference_mode():
        th, tc, taux = tmodel.forward(tparams, _t(toks[:, :S]), _t(pos), tmodel.ctx(),
                                      src_embeds=_t(src), src_pos=_t(src_pos))
    assert jc is None and tc is None and float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("attn_impl,approx", [
    pytest.param("xla", False, id="xla-exact"),
    pytest.param("pallas", False, id="pallas-exact"),
    pytest.param("xla", True, id="xla-bitexact-mlp+attn"),
    pytest.param("pallas", True, id="pallas-bitexact-mlp+attn"),
])
def test_prefill_and_teacher_forced_decode_logits_match_reference(attn_impl, approx,
                                                                  monkeypatch):
    """Prefill (encoder, cross K/V, the decoder's causal prefill over a
    cache of S + STEPS slots) and ``STEPS`` teacher-forced decode steps;
    under pallas the encoder runs the non-causal forward, the decoder's
    prefill the causal one and each decode step the flash decode (the
    approximate attention at bitexact), their plain versions here."""
    jmodel, jparams, tmodel, tparams = _pair(attn_impl, approx)
    src, src_pos, toks = _inputs(tmodel.cfg.d_model, seed=3)
    recorded = _force_reference_inputs(monkeypatch) if approx else []
    cap = S + STEPS
    jbatch = {"tokens": jnp.asarray(toks[:, :S]), "src_embeds": jnp.asarray(src),
              "src_pos": jnp.asarray(src_pos)}
    tbatch = {"tokens": _t(toks[:, :S]), "src_embeds": _t(src), "src_pos": _t(src_pos)}
    jcache, jlogits = jax_prefill_step(jmodel, cap, mem_len=S_SRC)(jparams, jbatch)
    jax.effects_barrier()
    with torch.inference_mode():
        tcache, tlogits = make_prefill_step(tmodel, cap, mem_len=S_SRC)(tparams, tbatch)
    assert not recorded
    assert [c.cross_k.shape for c in tcache] == [(B, S_SRC, 2, 16)] * tmodel.cfg.num_layers
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    jdec, tdec = jax_decode_step(jmodel), make_decode_step(tmodel)
    for step in range(STEPS):
        tok = toks[:, S + step:S + step + 1]
        jlogits, jcache = jdec(jparams, jcache, jnp.asarray(tok), jnp.int32(S + step))
        jax.effects_barrier()
        with torch.inference_mode():
            tlogits, tcache = tdec(tparams, tcache, _t(tok), S + step)
        assert not recorded
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL,
                                   err_msg=f"decode step {step}")


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


def _queue(pkg, quality):
    """Seven prompts of mixed lengths (left-padded into the bucket), budgets
    in [1, GEN]: three batches, the last a remainder."""
    return pkg.synth_requests(7, prompt_len=PROMPT, gen=GEN, vocab_size=256, seed=9,
                              quality=quality)


@pytest.mark.parametrize("quality", ["exact", "balanced"])
def test_static_loop_streams_equal_the_reference(quality, monkeypatch):
    """The static loop with its warmup in both packages (the warmup's
    batches draw encoder memory first, so the served batches then draw the
    same frames): the streams, the accounting and the stats equal the
    reference's."""
    jmodel, jparams, tmodel, tparams = _pair()
    recorded = (_force_reference_inputs(monkeypatch, jitted_outputs=True)
                if quality == "balanced" else [])
    jax_scheduler._static_steps.cache_clear()  # trace the recorder in
    shape = dict(batch_size=BATCH, prompt_len=PROMPT, gen=GEN, quality=quality, seed=4)
    queue = _queue(serve, quality)
    assert len({r.prompt_len for r in queue}) > 1 and len({r.max_new for r in queue}) > 1
    want = jax_serve.static_serve_loop(jmodel, jparams, _queue(jax_serve, quality), **shape)
    jax.effects_barrier()
    assert bool(recorded) == (quality == "balanced")
    with _Margins(tparams) as margins:
        got = serve.static_serve_loop(tmodel, tparams, queue, **shape)
    assert not recorded
    assert min(margins.seen) > MARGIN, "a greedy near-tie: streams may differ legitimately"
    assert sorted(got.outputs) == sorted(want.outputs)
    for rid, stream in got.outputs.items():
        np.testing.assert_array_equal(stream, want.outputs[rid], err_msg=f"request {rid}")
    assert dataclasses.astuple(got.accounting) == dataclasses.astuple(want.accounting)
    for field in ("requests", "tokens_out", "decode_steps", "slot_utilization", "quality",
                  "scheduler"):
        assert getattr(got.stats, field) == getattr(want.stats, field), field


def test_static_loop_memory_follows_the_seed():
    """Another seed draws another encoder memory, so the streams change."""
    _, _, tmodel, tparams = _pair()
    runs = [serve.static_serve_loop(tmodel, tparams, _queue(serve, None), batch_size=BATCH,
                                    prompt_len=PROMPT, gen=GEN, seed=seed).outputs
            for seed in (4, 4, 5)]
    assert all(np.array_equal(runs[0][r], runs[1][r]) for r in runs[0])
    assert any(not np.array_equal(runs[0][r], runs[2][r]) for r in runs[0])


def test_continuous_scheduler_refuses_encoder_decoder():
    """The reference's refusal, word for word: serve these with the static loop."""
    _, _, tmodel, tparams = _pair()
    with pytest.raises(ValueError, match="serve encoder-decoder configs with static_serve_loop"):
        serve.ContinuousScheduler(tmodel, tparams, batch_size=2, prompt_len=PROMPT,
                                  max_new=GEN)
    assert not serve.supports_continuous(tmodel.cfg)


def test_loader_round_trip_and_leaf_order():
    """``reference_leaves`` follows ``tree_leaves``' order and shapes over the
    reference's tree (the two stacks, their cross projections and norms,
    ``enc_final_norm``), and ``to_jax_layout`` gives the tree back."""
    jmodel, jparams, _, tparams = _pair()
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    leaves = reference_leaves(tparams)
    assert [tuple(k.key for k in path) for path, _ in flat] == [leaf.path for leaf in leaves]
    assert [x.ndim for _, x in flat] == [leaf.ndim for leaf in leaves]
    assert {leaf.path[-1] for leaf in leaves} >= {"cross_wq", "cross_wk", "cross_wv",
                                                  "cross_wo", "ln_cross", "enc_final_norm"}
    back = to_jax_layout(dict(tparams.named_parameters()), tparams)
    for a, (_, b) in zip(jax.tree_util.tree_leaves(back), flat):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_seeded_init_has_the_reference_scales():
    """The port's own init (used on the card): std d^-1/2 per projection,
    the cross ones included, zero norms, and ``param_count`` equal to the
    reference's."""
    cfg = get_config(ARCH).reduced(d_model=256, d_ff=512)
    model = build_model(cfg)
    params = model.init_params(0, device="cpu")
    jparams = jax_build_model(jax_get_config(ARCH).reduced(d_model=256, d_ff=512)).init_params(
        jax.random.PRNGKey(0))
    assert model.param_count(params) == sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    dec = params.dec_layers[0]
    for name, fan_in in (("cross_wq", 256), ("cross_wk", 256),
                         ("cross_wo", cfg.num_heads * cfg.head_dim)):
        assert abs(float(dec.cross[name].detach().std()) * fan_in**0.5 - 1.0) < 0.05, name
    assert abs(float(params.enc_layers[1].ffn["w2"].detach().std()) * 512**0.5 - 1.0) < 0.05
    assert not params.enc_final_norm.any() and not dec.ln_cross.any()
    assert len(params.enc_layers) == cfg.encoder_layers and len(params.dec_layers) == 2


def test_serve_cli_serves_seamless_through_the_static_loop():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--reduced",
         "--device", "cpu", "--requests", "4", "--batch", "2", "--gen", "4"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"# {ARCH}-smoke: auto-selected --scheduler static" in proc.stdout
    assert "[static] served 4 requests, 16 tokens" in proc.stdout
