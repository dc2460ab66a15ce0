"""The port's decoder stack against the JAX package on the same weights.

``qwen3-0.6b.reduced()`` is built in both packages, and so are gemma-7b,
gemma2-9b and yi-9b (their ``reduced()``, plus gemma-7b with one query
head per KV head, yi-9b with eight, and gemma2-9b at its full head width
of 256 under the attention kernels); the JAX model's own parameters are
turned into numpy and loaded into the port with ``from_jax_params``
(scanned layer groups, stacked on a leading axis, are unstacked per
layer).  The reduced gemma2-9b's window of 8 binds within the decode
steps over S = 8, and its layers alternate local and global attention
with both logit softcaps.  Prefill logits over left-padded prompts with
per-row positions, then several decode steps with per-row positions and
write slots, must agree in float32 within ``rtol=1e-5, atol=1e-5``: the
sums inside matmul and softmax run in another order in the two
frameworks.

With ``bitexact`` at an explicit (n=8, t=4), each approximate GEMM of the
port is checked to receive the reference's input within that tolerance
and is then fed the reference's input itself; under ``attn_impl="pallas"``
with ``attn`` targeted, so is each approximate attention call (its q, k
and v), and with ``moe`` targeted each layer's (E, C, d) expert-GEMM input.  The reason: an input that
differs in the last bit can sit on the other side of a rounding boundary
of the 8-bit quantizer, which moves its integer by one and the layer's
output by far more than 1e-5.  That is a property of quantization, met
at every size; given the same input, the port's integer GEMM is exact and
equal to the reference's (``test_torch_engine.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import apply_approx as jax_apply_approx
from repro.configs.registry import get_config as jax_get_config
from repro.models.registry import build_model as jax_build_model
from repro.train.steps import make_decode_step as jax_decode_step
from repro.train.steps import make_prefill_step as jax_prefill_step
from repro_torch.configs.registry import apply_approx, get_config
from repro_torch.models.registry import (
    build_model, from_jax_params, reference_leaves, to_jax_layout,
)
from repro_torch.train.steps import make_decode_step, make_prefill_step

B, S, T, STEPS = 2, 8, 16, 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(approx, attn_impl="xla", targets=("mlp",), arch="qwen3-0.6b", reduced=None, **over):
    reduced = reduced or {}
    jcfg = jax_get_config(arch).reduced(attn_impl=attn_impl, **reduced, **over)
    tcfg = get_config(arch).reduced(attn_impl=attn_impl, **reduced)
    if approx is not None:
        mode, n, t = approx
        jcfg = jax_apply_approx(jcfg, mode=mode, n=n, t=t, targets=targets)
        tcfg = apply_approx(tcfg, mode=mode, n=n, t=t, targets=targets)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, tmodel, tparams


def _force_reference_inputs(monkeypatch):
    """Record each approximate GEMM input, and the q, k and v of each
    approximate attention call, of the JAX model, and hand them to the
    port's matching call, after checking the port's own inputs."""
    import repro.kernels.approx_attention as jax_approx_attention
    import repro.models.layers as jax_layers
    import repro.models.moe as jax_moe
    import repro_torch.models.attention as port_attention
    import repro_torch.models.layers as port_layers
    import repro_torch.models.moe as port_moe

    recorded = []
    jax_approx_2d, port_approx_2d = jax_layers._approx_2d, port_layers._approx_2d
    jax_attn = jax_approx_attention.approx_flash_attention
    port_attn = port_attention.approx_flash_attention
    jax_experts, port_experts = jax_moe._expert_gemm, port_moe.expert_gemm

    def record(x2, w, ap, key):
        recorded.append(np.array(x2))  # a writable copy
        return jax_approx_2d(x2, w, ap, key)

    def forced(x2, w, ap, generator):
        want = recorded.pop(0)
        np.testing.assert_allclose(x2.numpy(), want, **TOL)
        return port_approx_2d(torch.from_numpy(want), w, ap, generator)

    def record_attn(q, k, v, *args):
        recorded.append(tuple(np.array(a) for a in (q, k, v)))
        return jax_attn(q, k, v, *args)

    def forced_attn(q, k, v, *args, **kw):
        want = recorded.pop(0)
        for got, w in zip((q, k, v), want):
            np.testing.assert_allclose(got.numpy(), w, **TOL)
        return port_attn(*(torch.from_numpy(w) for w in want), *args, **kw)

    def record_experts(x, w, ctx):
        recorded.append(np.array(x))
        return jax_experts(x, w, ctx)

    def forced_experts(x, w, ctx):
        want = recorded.pop(0)
        np.testing.assert_allclose(x.numpy(), want, **TOL)
        return port_experts(torch.from_numpy(want), w, ctx)

    monkeypatch.setattr(jax_moe, "_expert_gemm", record_experts)
    monkeypatch.setattr(port_moe, "expert_gemm", forced_experts)
    monkeypatch.setattr(jax_layers, "_approx_2d", record)
    monkeypatch.setattr(port_layers, "_approx_2d", forced)
    monkeypatch.setattr(jax_approx_attention, "approx_flash_attention", record_attn)
    monkeypatch.setattr(port_attention, "approx_flash_attention", forced_attn)
    return recorded


APPROX = {"exact": None, "bitexact-8-4": ("bitexact", 8, 4), "lowrank-8-4": ("lowrank", 8, 4)}
NEW_ARCHS = ("gemma-7b", "gemma2-9b", "yi-9b")
# shapes beyond reduced(): gemma-7b's one query head per KV head (its
# reduced() has 2 KV heads of 4), yi-9b's eight, gemma2-9b's head width
KV4, G8, HD256 = dict(num_kv_heads=4), dict(num_heads=16, num_kv_heads=2), dict(head_dim=256)


def _cases(tiers, extra):
    """(arch, reduced overrides, approx) cases: qwen3-0.6b under its tier
    ids, each new arch at every tier, then ``extra`` (arch, label,
    overrides, tier)."""
    cases = [pytest.param("qwen3-0.6b", {}, APPROX[t], id=t) for t in tiers]
    cases += [pytest.param(a, {}, APPROX[t], id=f"{a}-{t}") for a in NEW_ARCHS for t in tiers]
    cases += [pytest.param(a, over, APPROX[t], id=f"{a}-{label}-{t}")
              for a, label, over, t in extra]
    return cases


@pytest.mark.parametrize("arch,reduced,approx", _cases(
    ("exact", "bitexact-8-4"), [("gemma-7b", "kv4", KV4, "exact")]))
def test_prefill_and_decode_logits_match_reference(arch, reduced, approx, monkeypatch):
    _check_prefill_and_decode(approx, monkeypatch, arch=arch, reduced=reduced)


@pytest.mark.parametrize("arch,reduced,approx", _cases(
    ("exact", "bitexact-8-4", "lowrank-8-4"),
    [("gemma-7b", "kv4", KV4, "exact"), ("gemma2-9b", "hd256", HD256, "exact"),
     ("yi-9b", "g8", G8, "exact")]))
def test_pallas_attention_logits_match_reference(arch, reduced, approx, monkeypatch):
    """``attn_impl="pallas"``: prefill through flash_attention (exact) or
    approx_flash_attention (``targets=("mlp", "attn")``), every decode step
    through flash_decode, against the JAX kernels in interpret mode."""
    _check_prefill_and_decode(approx, monkeypatch, attn_impl="pallas",
                              targets=("mlp", "attn"), arch=arch, reduced=reduced)


# qwen2-vl-7b, granite-moe-1b-a400m and kimi-k2-1t-a32b at reduced(): the MoE
# capacity lifted to 8.0 for prefill and decode (capacity dropping depends on
# the batch, so a prefill and a step see other capacities), as
# tests/test_decode_parity.py does; qwen2-vl also with seven query heads per
# KV head at head width 128 (the published M-RoPE sections), as the card runs it
CF8 = dict(capacity_factor=8.0)
G7 = dict(num_heads=7, num_kv_heads=1, head_dim=128, mrope_sections=(16, 24, 24))
VL_MOE_ARCHS = ("qwen2-vl-7b", "granite-moe-1b-a400m", "kimi-k2-1t-a32b")


@pytest.mark.parametrize("arch,reduced,attn_impl,approx,targets", [
    pytest.param("qwen2-vl-7b", {}, "xla", None, (), id="qwen2-vl-exact"),
    pytest.param("qwen2-vl-7b", {}, "xla", APPROX["bitexact-8-4"], ("mlp",),
                 id="qwen2-vl-bitexact-mlp"),
    pytest.param("qwen2-vl-7b", {}, "pallas", None, (), id="qwen2-vl-pallas-exact"),
    pytest.param("qwen2-vl-7b", {}, "pallas", APPROX["bitexact-8-4"], ("mlp", "attn"),
                 id="qwen2-vl-pallas-bitexact-mlp-attn"),
    pytest.param("qwen2-vl-7b", G7, "pallas", None, (), id="qwen2-vl-g7-hd128-pallas-exact"),
    pytest.param("granite-moe-1b-a400m", CF8, "xla", None, (), id="granite-exact"),
    pytest.param("granite-moe-1b-a400m", CF8, "xla", APPROX["bitexact-8-4"], ("moe", "attn"),
                 id="granite-bitexact-moe-attn"),
    pytest.param("granite-moe-1b-a400m", CF8, "xla", APPROX["lowrank-8-4"], ("moe",),
                 id="granite-lowrank-moe"),
    pytest.param("granite-moe-1b-a400m", CF8, "pallas", None, (), id="granite-pallas-exact"),
    pytest.param("granite-moe-1b-a400m", CF8, "pallas", APPROX["bitexact-8-4"],
                 ("moe", "attn"), id="granite-pallas-bitexact-moe-attn"),
    pytest.param("kimi-k2-1t-a32b", CF8, "xla", None, (), id="kimi-exact"),
    pytest.param("kimi-k2-1t-a32b", CF8, "pallas", APPROX["bitexact-8-4"], ("moe",),
                 id="kimi-pallas-bitexact-moe"),
])
def test_vl_and_moe_prefill_and_decode_logits_match_reference(arch, reduced, attn_impl, approx,
                                                              targets, monkeypatch):
    _check_prefill_and_decode(approx, monkeypatch, attn_impl=attn_impl, targets=targets,
                              arch=arch, reduced=reduced)


def _full_forward_logits(jmodel, jparams, tmodel, tparams, toks, pos, embeds=None):
    """Logits of one forward over the whole sequence (no cache) in both
    packages, and both aux losses."""
    kw = {} if embeds is None else dict(embeds=embeds)
    jtoks = None if toks is None else jnp.asarray(toks)
    jhidden, _, jaux = jmodel.forward(jparams, jtoks, jnp.asarray(pos), jmodel.ctx(),
                                      **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.inference_mode():
        ttoks = None if toks is None else torch.from_numpy(toks).long()
        thidden, _, taux = tmodel.forward(tparams, ttoks, torch.from_numpy(pos), tmodel.ctx(),
                                          **{k: torch.from_numpy(v) for k, v in kw.items()})
        tlogits = tmodel.lm_head(tparams, thidden)
    return (np.asarray(jmodel.lm_head(jparams, jhidden)), float(jaux), tlogits.numpy(),
            float(taux))


@pytest.mark.parametrize("arch", VL_MOE_ARCHS)
def test_full_forward_at_the_configs_own_capacity_matches_reference(arch):
    """One forward over B 2 x S 12 at the config's own capacity factor
    (granite 1.25, kimi-k2 1.0: assignments dropped), logits within
    ``TOL`` and the summed aux loss within 1e-6."""
    jmodel, jparams, tmodel, tparams = _pair(None, arch=arch)
    s = 12
    toks = np.random.default_rng(3).integers(0, 256, (B, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s))
    if tmodel.cfg.use_mrope:
        pos = np.broadcast_to(pos, (3, B, s))
    pos = np.ascontiguousarray(pos)
    jl, jaux, tl, taux = _full_forward_logits(jmodel, jparams, tmodel, tparams, toks, pos)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert abs(taux - jaux) <= 1e-6 and (taux > 0) == (tmodel.cfg.num_experts > 0)


@pytest.mark.parametrize("attn_impl,reduced", [("xla", {}), ("pallas", {}), ("pallas", G7)],
                         ids=["xla", "pallas", "pallas-g7-hd128"])
def test_forward_with_patch_embeds_and_distinct_streams_matches_reference(attn_impl, reduced):
    """qwen2-vl's vision stream: patch embeddings in place of tokens, at
    t/h/w ids that differ (a frame of 3 x 4 patches after 2 text tokens),
    through the full forward in both packages."""
    jmodel, jparams, tmodel, tparams = _pair(None, attn_impl=attn_impl, arch="qwen2-vl-7b",
                                             reduced=reduced)
    s = 14
    embeds = np.random.default_rng(4).standard_normal((B, s, tmodel.cfg.d_model)).astype(
        np.float32)
    j = np.arange(s) - 2
    t = np.where(j < 0, np.arange(s), 2)
    pos = np.stack([t, np.where(j < 0, t, 2 + j // 4), np.where(j < 0, t, 2 + j % 4)])
    pos = np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B, s))).astype(np.int32)
    jl, _, tl, _ = _full_forward_logits(jmodel, jparams, tmodel, tparams, None, pos, embeds)
    np.testing.assert_allclose(tl, jl, **TOL)
    # the streams matter: the text-only positions give other logits
    flat = np.ascontiguousarray(np.broadcast_to(pos[:1], pos.shape))
    _, _, tl_text, _ = _full_forward_logits(jmodel, jparams, tmodel, tparams, None, flat, embeds)
    assert not np.allclose(tl_text, tl, **TOL)


def _check_prefill_and_decode(approx, monkeypatch, **kw):
    # the recorder reads concrete inputs, so the approximate case runs the
    # reference unscanned (lax.scan would hand it tracers)
    over = {} if approx is None else {"scan_layers": False}
    jmodel, jparams, tmodel, tparams = _pair(approx, **kw, **over)
    vocab = tmodel.cfg.vocab_size
    recorded = _force_reference_inputs(monkeypatch) if approx is not None else []
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    # row 1 is left-padded by 3: its pads carry negative positions
    pos = np.stack([np.arange(S), np.arange(S) - 3]).astype(np.int32)
    jcache, jlogits = jax_prefill_step(jmodel, T)(
        jparams, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}
    )
    with torch.inference_mode():
        tcache, tlogits = make_prefill_step(tmodel, T)(
            tparams, {"tokens": torch.from_numpy(toks).long(), "positions": torch.from_numpy(pos)}
        )
    assert not recorded
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    jdec, tdec = jax_decode_step(jmodel), make_decode_step(tmodel)
    tok = np.argmax(np.asarray(jlogits)[:, -1], -1).astype(np.int32)[:, None]
    for step in range(STEPS):
        p = (pos[:, -1] + 1 + step).astype(np.int32)
        w = np.full((B,), S + step, np.int32)
        jlogits, jcache = jdec(jparams, jcache, jnp.asarray(tok), jnp.asarray(p), jnp.asarray(w))
        with torch.inference_mode():
            tlogits, tcache = tdec(tparams, tcache, torch.from_numpy(tok).long(),
                                   torch.from_numpy(p), torch.from_numpy(w))
        assert not recorded
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL,
                                   err_msg=f"decode step {step}")
        tok = np.argmax(np.asarray(jlogits)[:, -1], -1).astype(np.int32)[:, None]


def test_unscanned_tree_loads_to_the_same_model():
    """``scan_layers=False`` keeps the layers in ``params["rem"]``; the
    loader reads both layouts, and each yields the reference's logits."""
    jmodel, jparams, tmodel, tparams = _pair(None, scan_layers=False)
    assert "rem" in jparams and "scan" not in jparams
    toks = np.random.default_rng(2).integers(0, 256, (B, S)).astype(np.int32)
    _, jlogits = jax_prefill_step(jmodel, T)(jparams, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        _, tlogits = make_prefill_step(tmodel, T)(tparams, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)


def test_seeded_init_has_the_reference_scales():
    """The port's own init (used on the card) draws with the scales of
    ``transformer.init_params``: std d^-1/2 per projection, zero norms."""
    cfg = get_config("qwen3-0.6b").reduced(d_model=256, d_ff=512, vocab_size=1024)
    params = build_model(cfg).init_params(0, device="cpu")
    block = params.layers[0]
    for name, fan_in in (("wq", 256), ("wo", cfg.num_heads * cfg.head_dim)):
        std = float(block.attn[name].std())
        assert abs(std * fan_in**0.5 - 1.0) < 0.05, (name, std)
    assert abs(float(block.ffn["w2"].std()) * 512**0.5 - 1.0) < 0.05
    assert float(params.embed.std()) * 256**0.5 == pytest.approx(1.0, abs=0.05)
    assert not params.final_norm.any() and not block.ln1.any()
    again = build_model(cfg).init_params(0, device="cpu")
    assert torch.equal(again.layers[1].ffn["w1"], params.layers[1].ffn["w1"])


def test_unported_block_kinds_raise():
    """Every block kind builds: the hybrid (RG-LRU + local attention) and SSD
    patterns, MoE feed-forwards and an encoder-decoder (both stacks, the
    decoder's cross projections); only an unknown arch name raises."""
    base = get_config("qwen3-0.6b").reduced()
    hybrid = dataclasses.replace(base, layer_pattern=("rglru", "rglru", "attn_local"),
                                 lru_width=64)
    params = build_model(hybrid).init_params(0, device="cpu")
    assert [b.kind for b in params.layers] == ["rglru", "rglru"]
    assert all(b.attn is None and b.rglru["lru_gate_w"].shape == (64, 64) for b in params.layers)
    ssm = dataclasses.replace(base, layer_pattern=("ssd",), d_ff=0, d_inner=128, ssm_heads=8,
                              ssm_head_dim=16, ssm_state=16)
    params = build_model(ssm).init_params(0, device="cpu")
    assert all(b.ffn is None and b.ssd["in_proj"].shape == (64, 2 * 128 + 2 * 16 + 8)
               for b in params.layers)
    encdec = dataclasses.replace(base, encoder_layers=3)
    params = build_model(encdec).init_params(0, device="cpu")
    assert len(params.enc_layers) == 3 and len(params.dec_layers) == base.num_layers
    hq = base.num_heads * base.head_dim
    assert all(b.cross["cross_wq"].shape == (64, hq) and b.cross["cross_wo"].shape == (hq, 64)
               for b in params.dec_layers)
    caches = build_model(encdec).init_caches(2, 12, torch.float32, "cpu", mem_len=5)
    assert [tuple(c.cross_k.shape) for c in caches] == [(2, 5, base.num_kv_heads,
                                                         base.head_dim)] * base.num_layers
    moe = dataclasses.replace(base, num_experts=4, num_experts_per_tok=2, moe_d_ff=32)
    params = build_model(moe).init_params(0, device="cpu")
    assert all(b.ffn is None and b.ffn_moe["we1"].shape == (4, 64, 32) for b in params.layers)
    with pytest.raises(KeyError, match="seamless-m4t-large-v2"):
        get_config("seamless-m4t-large-v3")


@pytest.mark.parametrize("arch,reduced", [("gemma2-9b", dict(num_layers=3)), ("yi-9b", {}),
                                          ("granite-moe-1b-a400m", {}), ("kimi-k2-1t-a32b", {}),
                                          ("qwen2-vl-7b", {}),
                                          ("recurrentgemma-2b", dict(num_layers=5)),
                                          ("mamba2-130m", dict(num_layers=4))],
                         ids=["gemma2-9b-group-and-remainder", "yi-9b-untied",
                              "granite-stacked-experts", "kimi-k2-stacked-experts-untied",
                              "qwen2-vl-untied", "recurrentgemma-period-3-two-remainders",
                              "mamba2-period-1"])
def test_loader_round_trips_the_reference_tree(arch, reduced):
    """gemma2-9b at three layers (one scanned group of its two kinds, one
    remainder layer), yi-9b (an untied ``lm_head``), recurrentgemma-2b at
    five layers (one (rglru, rglru, attn_local) group, two remainder RG-LRU
    layers, as the published 26 layers leave) and mamba2-130m (period one):
    the reference's tree goes through ``from_jax_params`` and back through
    ``to_jax_layout`` bit for bit, and ``reference_leaves`` names its leaves
    in ``jax.tree_util.tree_leaves`` order."""
    jcfg, tcfg = jax_get_config(arch).reduced(**reduced), get_config(arch).reduced(**reduced)
    tree = jax.tree_util.tree_map(np.asarray, jax_build_model(jcfg).init_params(
        jax.random.PRNGKey(0)))
    assert ("rem" in tree) == (tcfg.num_layers % len(tcfg.layer_pattern) > 0)
    assert ("lm_head" in tree) == (not tcfg.tie_embeddings)
    params = from_jax_params(tree, tcfg, device="cpu")
    back = to_jax_layout(dict(params.named_parameters()), params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    paths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path) for path, _ in flat]
    leaves = reference_leaves(params)
    assert [leaf.path for leaf in leaves] == paths
    assert [leaf.ndim for leaf in leaves] == [np.ndim(x) for _, x in flat]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_loader_keeps_the_router_float32_in_a_bf16_model(arch):
    """In a bfloat16 model the reference keeps each router float32; the
    loader does too, its stacked experts are (L, E, d, f) in the
    reference's layout, and the tree comes back with the same values."""
    jcfg = jax_get_config(arch).reduced(dtype="bfloat16", num_layers=3)
    tcfg = get_config(arch).reduced(dtype="bfloat16", num_layers=3)
    tree = jax.tree_util.tree_map(np.asarray, jax_build_model(jcfg).init_params(
        jax.random.PRNGKey(1)))
    stacked = tree["scan"]["sub0"]["ffn_moe"]
    assert stacked["router"].dtype == np.float32 and stacked["we1"].shape == (3, 4, 64, 32)
    params = from_jax_params(tree, tcfg, device="cpu")
    for block in params.layers:
        assert block.ffn_moe["router"].dtype == torch.float32
        assert block.ffn_moe["we1"].dtype == block.attn["wq"].dtype == torch.bfloat16
    back = to_jax_layout(dict(params.named_parameters()), params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    leaves = {leaf.path: leaf for leaf in reference_leaves(params)}
    assert leaves[("scan", "sub0", "ffn_moe", "we1")].ndim == 4
    assert leaves[("scan", "sub0", "ffn_moe", "router")].ndim == 3
    own = build_model(tcfg).init_params(0, device="cpu")
    assert own.layers[0].ffn_moe["router"].dtype == torch.float32
