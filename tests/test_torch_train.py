"""The port's training path against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through ``repro`` and its
counterpart in ``repro_torch``:

- ``SyntheticLM`` batches: bit-equal (the port keeps a copy of the
  numpy-only pipeline);
- chunked cross-entropy: loss at rtol 1e-5, gradients at rtol 1e-4 /
  atol 1e-6 (float32 sums in another order; the reference's own
  chunked-vs-dense tolerance);
- AdamW on identical gradients and parameters: the parameters at rtol
  1e-6 and the float32 moments within 1e-6 * max|want| per leaf (the
  schedule's cos and pow, and with clipping the global norm, a float32 sum
  over leaves in another order, may differ by an ulp; a moment near 0 is
  the difference of two nearly equal terms), the 8-bit moments' codes
  bit-equal and their scales at rtol 1e-6;
- compression: bit-equal (elementwise float32 with true divisions);
- one train step of reduced qwen3-0.6b from converted parameters (exact;
  paper-multiplier; bitexact on mlp+attn with ``attn_impl="pallas"``), and
  of reduced qwen2-vl-7b (M-RoPE; also on patch embeddings),
  granite-moe-1b-a400m and kimi-k2-1t-a32b (the MoE aux loss in the loss,
  assignments dropped at their own capacity; granite also bitexact on
  moe+attn under the Pallas path), reduced mamba2-130m and
  recurrentgemma-2b (the two scans; recurrentgemma also under the Pallas
  path) and seamless-m4t-large-v2 (both packages fed the same
  ``src_embeds``; also under the Pallas path): loss at rtol 1e-5, aux within 1e-6 and
  every gradient within 1e-4 * max|want| of
  ``jax.value_and_grad(repro.train.steps.loss_fn)``.  In the approximate
  cases every approximate GEMM (and attention) call of the port is first
  checked to receive the reference's input within 1e-5 and then fed that
  input itself, with the gradient passed through: an input a few ulps off
  can sit across a rounding boundary of the 8-bit quantizer, which moves
  an integer by one and a gradient by far more than the tolerance
  (``tests/test_torch_model.py`` does the same for the forward).
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
import jax.numpy as jnp
import torch.utils.checkpoint

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import apply_approx as jax_apply_approx
from repro.configs.registry import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models.registry import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.optim import compress as jax_compress
from repro.train import losses as jax_losses
from repro.train.steps import loss_fn as jax_loss_fn
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import apply_approx, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import transformer
from repro_torch.models.registry import build_model, from_jax_params, reference_leaves
from repro_torch.models.registry import to_jax_layout
from repro_torch.optim import adamw, compress
from repro_torch.train import losses, steps

ROOT = pathlib.Path(__file__).resolve().parent.parent
GRAD_TOL = 1e-4  # times max|want|, per gradient


def _np(x):
    return np.asarray(x.detach()) if torch.is_tensor(x) else np.asarray(x)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,vocab", [(0, 151936), (1, 256)])
def test_synthetic_batches_bit_equal(seed, vocab):
    kw = dict(vocab_size=vocab, seq_len=80, global_batch=4, seed=seed)
    want, got = JaxSyntheticLM(JaxDataConfig(**kw)), SyntheticLM(DataConfig(**kw))
    for step in range(3):
        a, b = want.batch(step), got.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    half = SyntheticLM(DataConfig(**kw), process_index=1, process_count=2)
    np.testing.assert_array_equal(half.batch(2)["tokens"], want.batch(2)["tokens"][2:])


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("v,chunk", [(100, 32), (64, 64)], ids=["padded-last-chunk", "one"])
@pytest.mark.parametrize("softcap", [None, 30.0], ids=["plain", "softcap"])
def test_chunked_ce_and_gradients_match_reference(v, chunk, softcap):
    rng = np.random.default_rng(v)
    hidden = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((16, v)) * 0.5).astype(np.float32)
    labels = rng.integers(0, v, (2, 8)).astype(np.int32)
    labels[0, :3] = v - 1  # labels in the padded last chunk
    want, (gh, gw) = jax.value_and_grad(
        lambda h, w_: jax_losses.chunked_cross_entropy(h, w_, jnp.asarray(labels),
                                                       softcap=softcap, v_chunk=chunk),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(w))
    th, tw = torch.tensor(hidden, requires_grad=True), torch.tensor(w, requires_grad=True)
    got = losses.chunked_cross_entropy(th, tw, torch.from_numpy(labels), softcap=softcap,
                                       v_chunk=chunk)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), rtol=1e-4, atol=1e-6)
    dense = losses.cross_entropy_dense(th.detach() @ tw.detach(), torch.from_numpy(labels),
                                       softcap=softcap)
    np.testing.assert_allclose(float(dense), float(want), rtol=1e-5)


# -------------------------------------------------------------- optimizer
def _random_tree(cfg, seed):
    """The reference's (stacked) parameter tree for ``cfg`` with every leaf,
    the norm vectors included, drawn anew from a seed."""
    jparams = jax_build_model(cfg).init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.5).astype(np.float32), jparams)


def _opt_leaves(opt, bits):
    """The reference's moments as (code, scale) pairs or arrays, per leaf."""
    if bits == 8:
        is_q8 = lambda x: isinstance(x, jax_adamw._Q8)
        return [[(np.asarray(q.code), np.asarray(q.scale))
                 for q in jax.tree_util.tree_leaves(m, is_leaf=is_q8)] for m in (opt.mu, opt.nu)]
    return [[np.asarray(x) for x in jax.tree_util.tree_leaves(m)] for m in (opt.mu, opt.nu)]


def _assert_moments_equal(port_opt, ref_opt, bits):
    for mine, theirs in zip((port_opt.mu, port_opt.nu), _opt_leaves(ref_opt, bits)):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            if bits == 8:
                np.testing.assert_array_equal(a.code.numpy(), b[0].reshape(a.code.shape))
                np.testing.assert_allclose(a.scale.numpy(), b[1], rtol=1e-6)
            else:  # a moment near 0 comes out of a cancellation: held per leaf
                err = np.abs(a.numpy() - b.reshape(-1)).max()
                assert err <= 1e-6 * np.abs(b).max(), (err, np.abs(b).max())


# the reduced trees: qwen3-0.6b's one stacked group; gemma2-9b's period-2
# (local, global) group with a remainder layer, and its post-norms;
# granite-moe-1b-a400m's experts stacked (L, E, d, f) beside the router;
# seamless-m4t-large-v2's encoder and decoder stacks (the recurrent
# families' stacked layouts, on which decay is keyed, are held leaf for leaf
# in tests/test_torch_model.py's loader test)
ADAMW_TREES = {"qwen3-0.6b": {}, "gemma2-9b": dict(num_layers=3),
               "granite-moe-1b-a400m": {}, "seamless-m4t-large-v2": {}}


@pytest.mark.parametrize("arch", sorted(ADAMW_TREES))
@pytest.mark.parametrize("bits", [32, 8])
@pytest.mark.parametrize("grad_scale", [1e-3, 1.0], ids=["unclipped", "clipped"])
def test_adamw_matches_reference_on_a_stacked_tree(bits, grad_scale, arch):
    """Three steps on the reduced model's stacked tree (norms random, so
    their weight decay shows), identical gradients.  The port starts its
    second step from the reference's state (``from_reference``).  With
    clipping active the clip factor comes from the global norm, a float32
    sum over leaves in another order; in 8-bit a moment that sits a hair
    from a rounding boundary then moves by one code and moves its parameter
    in the next step, so 8-bit with clipping is compared over one step."""
    cfg = jax_get_config(arch).reduced(**ADAMW_TREES[arch])
    tree = _random_tree(cfg, seed=bits)
    tparams = from_jax_params(tree, get_config(arch).reduced(**ADAMW_TREES[arch]), device="cpu")
    leaves = reference_leaves(tparams)
    named = dict(tparams.named_parameters())
    jtcfg = JaxTrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=6, opt_state_bits=bits)
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=6, opt_state_bits=bits)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jopt = jax_adamw.init(jparams, jtcfg)
    topt = adamw.init(leaves, named, tcfg)
    rng = np.random.default_rng(7)
    flat, treedef = jax.tree_util.tree_flatten(jparams)
    n_steps = 1 if bits == 8 and grad_scale >= 1 else 3
    for step in range(n_steps):
        g = [(rng.standard_normal(x.shape) * grad_scale).astype(np.float32) for x in flat]
        jgrads = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in g])
        jparams, jopt, jm = jax_adamw.update(jgrads, jopt, jparams, jtcfg)
        tgrads = [torch.from_numpy(x.reshape(-1)) for x in g]  # tree_leaves order = leaves order
        topt, tm = adamw.update(leaves, named, tgrads, topt, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        want = to_jax_layout(named, tparams)
        for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
        _assert_moments_equal(topt, jopt, bits)
        if step == 0:  # continue from the reference's own state
            mu, nu = _opt_leaves(jopt, bits)
            topt = adamw.from_reference(int(jopt.step), mu, nu)
    assert int(topt.step) == n_steps


def test_weight_decay_follows_the_reference_layout():
    """Trouble spot: the reference decays every leaf with ndim >= 2; its
    train driver stacks the per-layer norms to (L, D), so they are decayed,
    and final_norm (D,) is not.  The port keys decay on that layout."""
    tparams = build_model(get_config("qwen3-0.6b").reduced()).init_params(0, device="cpu")
    by_path = {leaf.path: leaf for leaf in reference_leaves(tparams)}
    assert by_path[("final_norm",)].ndim == 1
    for name in (("ln1",), ("ln2",), ("attn", "q_norm_scale"), ("attn", "wq")):
        leaf = by_path[("scan", "sub0", *name)]
        assert leaf.ndim >= 2 and len(leaf.names) == 2
    unscanned = build_model(get_config("qwen3-0.6b").reduced(scan_layers=False))
    flat = reference_leaves(unscanned.init_params(0, device="cpu"))
    assert {leaf.ndim for leaf in flat if leaf.path[-1] == "ln1"} == {1}


def test_compress_matches_reference_and_keeps_the_residual_invariant():
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((32, 32)).astype(np.float32),
         "b": (rng.standard_normal(300) * 1e-3).astype(np.float32)}
    jstate = jax_compress.init_state(g)
    tstate = compress.init_state([x.size for x in g.values()], "cpu")
    for _ in range(2):
        jdeq, jstate, jm = jax_compress.compress_grads(g, jstate)
        flat = [torch.from_numpy(x.reshape(-1)) for x in g.values()]
        before = [r.clone() for r in tstate.residual]
        tdeq, tstate, tm = compress.compress_grads(flat, tstate)
        for k, d, r, x, e in zip(g, tdeq, tstate.residual, flat, before):
            np.testing.assert_array_equal(d.numpy(), np.asarray(jdeq[k]).reshape(-1))
            np.testing.assert_array_equal(r.numpy(), np.asarray(jstate.residual[k]).reshape(-1))
            # deq + residual' == grad + residual (lossless bookkeeping)
            np.testing.assert_allclose((d + r).numpy(), (x + e).numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(tm["compress_residual_sq"]),
                                   float(jm["compress_residual_sq"]), rtol=1e-6)


# ------------------------------------------------------------- train step
class _Replace(torch.autograd.Function):
    """The value ``want``, the gradient of ``x``: feeds the reference's
    input to a call without cutting the graph."""

    @staticmethod
    def forward(ctx, x, want):
        return want.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def _record_reference_inputs(monkeypatch, jcfg, jparams, jbatch):
    """Run the reference's loss once, recording each approximate GEMM's
    input (and each approximate attention's q, k, v)."""
    import repro.kernels.approx_attention as jax_approx_attention
    import repro.models.layers as jax_layers
    import repro.models.moe as jax_moe

    recorded = []
    orig_2d, orig_attn = jax_layers._approx_2d, jax_approx_attention.approx_flash_attention
    orig_experts = jax_moe._expert_gemm

    def record(x2, w, ap, key):
        recorded.append(np.array(x2))
        return orig_2d(x2, w, ap, key)

    def record_attn(q, k, v, *args):
        recorded.append(tuple(np.array(a) for a in (q, k, v)))
        return orig_attn(q, k, v, *args)

    def record_experts(x, w, ctx):
        recorded.append(np.array(x))
        return orig_experts(x, w, ctx)

    with monkeypatch.context() as m:
        m.setattr(jax_layers, "_approx_2d", record)
        m.setattr(jax_approx_attention, "approx_flash_attention", record_attn)
        m.setattr(jax_moe, "_expert_gemm", record_experts)
        jax_loss_fn(jparams, jbatch, jax.random.PRNGKey(1), jax_build_model(jcfg))
    return recorded


def _force_port_inputs(monkeypatch, recorded):
    import repro_torch.models.attention as port_attention
    import repro_torch.models.layers as port_layers
    import repro_torch.models.moe as port_moe

    orig_2d, orig_attn = port_layers._approx_2d, port_attention.approx_flash_attention
    orig_experts = port_moe.expert_gemm

    def forced(x2, w, ap, generator):
        want = recorded.pop(0)
        np.testing.assert_allclose(_np(x2), want, rtol=1e-5, atol=1e-5)
        return orig_2d(_Replace.apply(x2, torch.from_numpy(want)), w, ap, generator)

    def forced_attn(q, k, v, *args, **kw):
        want = recorded.pop(0)
        for got, w in zip((q, k, v), want):
            np.testing.assert_allclose(_np(got), w, rtol=1e-5, atol=1e-5)
        qkv = [_Replace.apply(a, torch.from_numpy(w)) for a, w in zip((q, k, v), want)]
        return orig_attn(*qkv, *args, **kw)

    def forced_experts(x, w, ctx):
        want = recorded.pop(0)
        np.testing.assert_allclose(_np(x), want, rtol=1e-5, atol=1e-5)
        return orig_experts(_Replace.apply(x, torch.from_numpy(want)), w, ctx)

    monkeypatch.setattr(port_layers, "_approx_2d", forced)
    monkeypatch.setattr(port_attention, "approx_flash_attention", forced_attn)
    monkeypatch.setattr(port_moe, "expert_gemm", forced_experts)


# gemma2-9b: period-2 (local, global) groups and a remainder layer, both
# softcaps, post-norms, tied embeddings, the reduced window of 8 binding at
# seq 16, under the Pallas-path attention (the flash forward with lse and
# the backward pair); unscanned, as the reference's train driver runs a
# remainder; also at gemma's head width 256
GEMMA2_STEP = dict(num_layers=3, attn_impl="pallas", scan_layers=False)
EXACT_STEPS = {
    "exact": ("qwen3-0.6b", {}),
    "gemma2-9b-pallas": ("gemma2-9b", GEMMA2_STEP),
    "gemma2-9b-pallas-hd256": ("gemma2-9b", dict(GEMMA2_STEP, head_dim=256)),
    "yi-9b": ("yi-9b", {}),  # an untied lm_head
    # M-RoPE over text-only streams; then on patch embeddings (below)
    "qwen2-vl": ("qwen2-vl-7b", {}),
    "qwen2-vl-embeds": ("qwen2-vl-7b", {}),
    # the aux loss; capacity 1.25 and 1.0 drop assignments at 2 x 16 tokens
    "granite-moe": ("granite-moe-1b-a400m", {}),
    "kimi-k2": ("kimi-k2-1t-a32b", {}),
    # the SSD scan, stacked with period 1; the RG-LRU's (rglru, rglru,
    # attn_local) group with two remainder layers, the window of 8 binding,
    # also under the Pallas-path attention
    "mamba2": ("mamba2-130m", {}),
    "recurrentgemma": ("recurrentgemma-2b", dict(num_layers=5)),
    "recurrentgemma-pallas": ("recurrentgemma-2b", dict(num_layers=5, attn_impl="pallas")),
    # the encoder-decoder on the same src_embeds (the encoder's non-causal
    # and the decoder's causal forward and backward under pallas)
    "seamless": ("seamless-m4t-large-v2", {}),
    "seamless-pallas": ("seamless-m4t-large-v2", dict(attn_impl="pallas")),
}


def _step_configs(case):
    if case in EXACT_STEPS:
        arch, over = EXACT_STEPS[case]
        return jax_get_config(arch).reduced(**over), get_config(arch).reduced(**over)
    if case == "paper-multiplier":
        # unscanned: the recorder reads concrete inputs, which lax.scan does not give
        return (jax_get_config("paper-multiplier").reduced(scan_layers=False),
                get_config("paper-multiplier").reduced(scan_layers=False))
    over = dict(attn_impl="pallas", scan_layers=False)
    arch, targets = {"bitexact-mlp+attn-pallas": ("qwen3-0.6b", ("mlp", "attn")),
                     "granite-bitexact-moe+attn-pallas": ("granite-moe-1b-a400m",
                                                          ("moe", "attn"))}[case]
    kw = dict(mode="bitexact", n=8, t=4, targets=targets)
    return (jax_apply_approx(jax_get_config(arch).reduced(**over), **kw),
            apply_approx(get_config(arch).reduced(**over), **kw))


@pytest.mark.parametrize("case", ["exact", "paper-multiplier", "bitexact-mlp+attn-pallas",
                                  "gemma2-9b-pallas", "gemma2-9b-pallas-hd256", "yi-9b",
                                  "qwen2-vl", "qwen2-vl-embeds", "granite-moe", "kimi-k2",
                                  "granite-bitexact-moe+attn-pallas", "mamba2",
                                  "recurrentgemma", "recurrentgemma-pallas", "seamless",
                                  "seamless-pallas"])
def test_train_step_loss_and_gradients_match_reference(case, monkeypatch):
    jcfg, tcfg = _step_configs(case)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    toks = np.random.default_rng(4).integers(0, 256, (2, 17)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long()}
    if case.endswith("-embeds"):
        embeds = np.random.default_rng(5).standard_normal((2, 16, tcfg.d_model)).astype(
            np.float32)
        jbatch["embeds"], batch["embeds"] = jnp.asarray(embeds), torch.from_numpy(embeds)
    if tcfg.is_encdec:  # frames of another length than the tokens'
        src = np.random.default_rng(6).standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
        jbatch["src_embeds"], batch["src_embeds"] = jnp.asarray(src), torch.from_numpy(src)
    if case not in EXACT_STEPS:
        _force_port_inputs(monkeypatch,
                           _record_reference_inputs(monkeypatch, jcfg, jparams, jbatch))
    (want_loss, want_parts), jgrads = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        jparams, jbatch, jax.random.PRNGKey(1), jmodel)

    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    seen = {}
    orig_update = adamw.update

    def update(leaves, params, flat_g, opt, cfg):
        seen["grads"] = [g.clone() for g in flat_g]
        return orig_update(leaves, params, flat_g, opt, cfg)

    monkeypatch.setattr(adamw, "update", update)
    ttcfg = TrainConfig(total_steps=4, warmup_steps=1)
    state = steps.init_train_state(tmodel, ttcfg, 0, device="cpu")
    state = state._replace(params=tparams, opt=adamw.init(reference_leaves(tparams),
                                                          dict(tparams.named_parameters()),
                                                          ttcfg))
    state, metrics = steps.make_train_step(tmodel, ttcfg)(state, batch)
    # in both packages the metrics' "loss" is the CE (the parts override it)
    np.testing.assert_allclose(float(metrics["loss"]), float(want_parts["loss"]), rtol=1e-5)
    assert abs(float(metrics["aux"]) - float(want_parts["aux"])) <= 1e-6
    total = float(metrics["loss"]) + steps.AUX_COEF * float(metrics["aux"])
    np.testing.assert_allclose(total, float(want_loss), rtol=1e-5)
    assert (float(metrics["aux"]) > 0) == (tcfg.num_experts > 0)
    want = [np.asarray(g).reshape(-1) for g in jax.tree_util.tree_leaves(jgrads)]
    assert len(want) == len(seen["grads"]) == len(reference_leaves(tparams))
    for leaf, got, w in zip(reference_leaves(tparams), seen["grads"], want):
        err = np.abs(got.numpy() - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (leaf.path, err, np.abs(w).max())
    assert int(state.step) == 1 and float(metrics["grad_norm"]) > 0


# ------------------------------------------------------- port-only checks
def _small(**over):
    return get_config("qwen3-0.6b").reduced(num_layers=2, d_model=32, d_ff=64, vocab_size=64,
                                            num_heads=2, num_kv_heads=1, head_dim=8, **over)


def _batch(cfg, b=4, s=16, seed=0):
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                                  seed=seed))
    return {k: torch.from_numpy(v).long() for k, v in data.batch(0).items()}


def _one_step_grads(cfg, tcfg, batch, monkeypatch):
    seen = {}
    orig_update = adamw.update

    def update(leaves, params, flat_g, opt, c):
        seen["grads"] = [g.to(torch.float32).clone() for g in flat_g]
        return orig_update(leaves, params, flat_g, opt, c)

    monkeypatch.setattr(adamw, "update", update)
    model = build_model(cfg)
    state = steps.init_train_state(model, tcfg, 3, device="cpu")
    _, metrics = steps.make_train_step(model, tcfg)(state, batch)
    return float(metrics["loss"]), seen["grads"]


def test_grad_accum_matches_a_single_batch(monkeypatch):
    cfg, batch = _small(), _batch(_small())
    one = _one_step_grads(cfg, TrainConfig(total_steps=4, warmup_steps=1), batch, monkeypatch)
    two = _one_step_grads(cfg, TrainConfig(total_steps=4, warmup_steps=1, grad_accum=2), batch,
                          monkeypatch)
    np.testing.assert_allclose(two[0], one[0], rtol=1e-6)
    for a, b in zip(two[1], one[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_inject_noise_is_redrawn_equal_under_remat(remat, monkeypatch):
    """inject draws Gaussian noise in every approximate GEMM.  Under remat
    the backward recomputes each block; each block's generator is made anew
    from (seed, layer), so the recomputed activations equal the first pass
    and the gradients equal those of the run that saved everything."""
    cfg = apply_approx(_small(remat=remat), mode="inject", n=8, t=4, targets=("mlp", "attn"))
    batch = _batch(cfg)
    outputs = []

    def hook(module, args, out):
        outputs.append(out[0].detach().clone())

    monkeypatch.setattr(transformer.Block, "__init__", _with_hook(transformer.Block.__init__,
                                                                  hook))
    tcfg = TrainConfig(total_steps=4, warmup_steps=1)
    # run each recompute to the block's end (by default it stops once the
    # saved tensors are back, before the block's hook would fire)
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        loss, grads = _one_step_grads(cfg, tcfg, batch, monkeypatch)
    n = cfg.num_layers
    assert len(outputs) == 2 * n  # the forward, then the recompute, last block first
    for first, again in zip(outputs[:n], reversed(outputs[n:])):
        assert torch.equal(first, again)
    outputs.clear()
    loss0, grads0 = _one_step_grads(dataclasses.replace(cfg, remat="none"), tcfg, batch,
                                    monkeypatch)
    assert len(outputs) == n and loss0 == loss
    for a, b in zip(grads, grads0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9)


def _with_hook(init, hook):
    def wrapped(self, *args, **kw):
        init(self, *args, **kw)
        self.register_forward_hook(hook)
    return wrapped


@pytest.mark.parametrize("bits,comp,lr", [(8, 0, 1e-3), (32, 8, 3e-3)],
                         ids=["8bit-moments", "int8-compression"])
def test_training_lowers_the_loss(bits, comp, lr):
    """Each option on its own; together, 8-bit moments and compression
    diverge at this size in the reference too (a moment whose block absmax
    is far larger quantizes to 0, and its step becomes m / 1e-8)."""
    cfg = _small()
    tcfg = TrainConfig(total_steps=12, warmup_steps=2, learning_rate=lr, opt_state_bits=bits,
                       grad_compress_bits=comp)
    model = build_model(cfg)
    state = steps.init_train_state(model, tcfg, 0, device="cpu")
    step_fn = steps.make_train_step(model, tcfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
    losses_ = []
    for i in range(12):
        batch = {k: torch.from_numpy(v).long() for k, v in data.batch(i % 2).items()}
        state, m = step_fn(state, batch)
        losses_.append(float(m["loss"]))
    assert np.mean(losses_[-3:]) < np.mean(losses_[:3]), losses_
    assert isinstance(state.opt.mu[0], adamw.Q8) == (bits == 8)
    assert (state.comp is not None) == bool(comp)
    if comp:
        assert np.isfinite(float(m["compress_residual_sq"]))


@pytest.mark.parametrize("arch", ["paper-multiplier", "gemma2-9b", "qwen2-vl-7b",
                                  "granite-moe-1b-a400m", "kimi-k2-1t-a32b", "mamba2-130m",
                                  "recurrentgemma-2b", "seamless-m4t-large-v2"])
def test_cpu_train_cli_lowers_the_loss(arch):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--device", "cpu", "--steps", "16", "--batch", "2", "--seq", "32"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert re.search(rf"arch={arch}-smoke params=[\d.]+M devices=1", proc.stdout)
    m = re.search(r"loss ([\d.]+) -> ([\d.]+)", proc.stdout)
    assert m, proc.stdout
    assert float(m.group(2)) < float(m.group(1)), proc.stdout


@pytest.mark.parametrize("arch,name,embeds,raises", [
    ("qwen3-0.6b", "final_norm", False, True),
    ("qwen3-0.6b", "embed", False, True),
    ("qwen2-vl-7b", "embed", False, True),
    ("qwen2-vl-7b", "embed", True, False),
], ids=["final-norm", "embed-without-frontend", "embed-of-tokens", "embed-fed-embeds"])
def test_only_a_table_fed_embeddings_may_miss_the_loss(arch, name, embeds, raises):
    """A parameter the loss does not reach raises in ``_grads``, except the
    token table of a frontend model fed ``embeds``, whose gradient is zero."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init_params(0, device="cpu")
    batch = _batch(cfg, b=2, s=8)
    if embeds:
        batch["embeds"] = torch.zeros((2, 8, cfg.d_model))
    leaves = reference_leaves(params)
    loss, _ = steps.loss_fn(params, batch, 0, model)
    loss.backward()
    getattr(params, name).grad = None
    if raises:
        with pytest.raises(RuntimeError, match=f"parameter '{name}' has no gradient"):
            steps._grads(params, leaves, batch)
    else:
        flat = steps._grads(params, leaves, batch)
        at = [leaf.path for leaf in leaves].index(("embed",))
        assert not flat[at].any()
