"""The port's RG-LRU and SSD blocks and the two recurrent families against the JAX package.

``rglru_block`` and ``ssd_block`` run in both packages on the reference's
own block parameters (float32, reduced widths): a prefill of 13 tokens
at chunk 8 (two chunks, the second with a padded tail) into a fresh
cache, then a chain of single-token decode steps on the carried cache,
exact and ``bitexact`` through the ``mlp`` target.  In the ``bitexact``
cases each approximate GEMM of the port is first checked to get the
reference's input within ``TOL`` and is then fed the reference's input
itself (an ulp can cross a rounding boundary of the 8-bit quantizer, as
``test_torch_model.py`` explains); its output must then equal the
reference's GEMM output bit for bit (integer sums well under 2^24, one
scale).  Then reduced mamba2-130m and recurrentgemma-2b at four layers
(recurrentgemma: one scanned (rglru, rglru, attn_local) group and one
remainder layer) through prefill and teacher-forced decode, under
``attn_impl`` "xla" and "pallas" (the reference's kernels in interpret
mode).  Everything within ``TOL``, ``tests/test_torch_model.py``'s:
float32 sums run in another order in the two frameworks, and the port's
log-depth scan combines in another order than ``associative_scan``.

Also: the long-prompt scan against a step-by-step recurrence, the
float32 leaves of a bf16 model, and a bf16 train step of each family.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
from repro.configs.registry import apply_approx as jax_apply_approx
from repro.configs.registry import get_config as jax_get_config
from repro.models import rglru as jax_rglru
from repro.models import ssd as jax_ssd
from repro.models.layers import Ctx as JaxCtx
from repro.models.registry import build_model as jax_build_model
from repro.train.steps import make_decode_step as jax_decode_step
from repro.train.steps import make_prefill_step as jax_prefill_step
import repro_torch.models.layers as port_layers
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import apply_approx, get_config
from repro_torch.models import rglru, ssd
from repro_torch.models.layers import Ctx
from repro_torch.models.registry import build_model, from_jax_params
from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, STEPS = 2, 13, 5
MODEL_STEPS = 3  # decode steps of the model cases (each a reference trace)
ARCH = {"rglru": "recurrentgemma-2b", "ssd": "mamba2-130m"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: at these sizes it is faster than many, and it
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch, approx, **over):
    jcfg, tcfg = jax_get_config(arch).reduced(**over), get_config(arch).reduced(**over)
    if approx:
        # the recorder reads concrete inputs: the reference runs unscanned
        jcfg = dataclasses.replace(jax_apply_approx(jcfg, mode="bitexact", n=8, t=4),
                                   scan_layers=False)
        tcfg = apply_approx(tcfg, mode="bitexact", n=8, t=4)
    return jcfg, tcfg


def _force_reference_gemms(monkeypatch):
    """Record each approximate GEMM's input and output in the reference and
    hand the input to the port's matching call, whose output must equal the
    reference's bit for bit."""
    recorded = []
    jax_gemm, port_gemm = jax_layers._approx_2d, port_layers._approx_2d

    def record(x2, w, ap, key):
        out = jax_gemm(x2, w, ap, key)
        recorded.append((np.array(x2), np.array(out)))
        return out

    def forced(x2, w, ap, generator):
        want_in, want_out = recorded.pop(0)
        np.testing.assert_allclose(x2.numpy(), want_in, **TOL)
        out = port_gemm(torch.from_numpy(want_in), w, ap, generator)
        np.testing.assert_array_equal(out.numpy(), want_out)
        return out

    monkeypatch.setattr(jax_layers, "_approx_2d", record)
    monkeypatch.setattr(port_layers, "_approx_2d", forced)
    return recorded


def _block_params(kind, jcfg, tcfg):
    init = {"rglru": jax_rglru.init_rglru, "ssd": jax_ssd.init_ssd}[kind]
    jp = init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "bitexact-mlp"])
@pytest.mark.parametrize("kind", ["rglru", "ssd"])
def test_block_prefill_and_decode_chain_match_reference(kind, approx, monkeypatch):
    """One block: prefill of 13 tokens (chunks of 8: two, a padded tail) into
    a fresh cache, then ``STEPS`` decode steps on it; outputs and every
    cache field within ``TOL`` at each step."""
    jcfg, tcfg = _configs(ARCH[kind], approx)
    assert jcfg.ssm_chunk == 8 and S % 8
    jp, tp = _block_params(kind, jcfg, tcfg)
    recorded = _force_reference_gemms(monkeypatch) if approx else []
    jblock = {"rglru": jax_rglru.rglru_block, "ssd": jax_ssd.ssd_block}[kind]
    tblock = {"rglru": rglru.rglru_block, "ssd": ssd.ssd_block}[kind]
    jinit = {"rglru": jax_rglru.init_rglru_cache, "ssd": jax_ssd.init_ssd_cache}[kind]
    tinit = {"rglru": rglru.init_rglru_cache, "ssd": ssd.init_ssd_cache}[kind]
    x = np.random.default_rng(5).standard_normal((B, S + STEPS, jcfg.d_model)).astype(np.float32)
    jcache = jinit(jcfg, B, jnp.float32)
    tcache = tinit(tcfg, B, torch.float32, "cpu")
    jctx, tctx = JaxCtx(cfg=jcfg), Ctx(cfg=tcfg)
    for lo, hi in [(0, S)] + [(S + i, S + i + 1) for i in range(STEPS)]:
        jout, jcache = jblock(jp, jnp.asarray(x[:, lo:hi]), jctx, cache=jcache)
        with torch.inference_mode():
            tout, tcache = tblock(tp, torch.from_numpy(x[:, lo:hi]), tctx, cache=tcache)
        assert not recorded
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL,
                                   err_msg=f"output at [{lo}, {hi})")
        for field, got, want in zip(tcache._fields, tcache, jcache):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"cache {field} at [{lo}, {hi})")


@pytest.mark.parametrize("kind", ["rglru", "ssd"])
def test_block_without_cache_matches_reference(kind):
    """The training-shaped call (no cache) over 13 tokens: the same output."""
    jcfg, tcfg = _configs(ARCH[kind], False)
    jp, tp = _block_params(kind, jcfg, tcfg)
    jblock = {"rglru": jax_rglru.rglru_block, "ssd": jax_ssd.ssd_block}[kind]
    tblock = {"rglru": rglru.rglru_block, "ssd": ssd.ssd_block}[kind]
    x = np.random.default_rng(6).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jout, jcache = jblock(jp, jnp.asarray(x), JaxCtx(cfg=jcfg))
    tout, tcache = tblock(tp, torch.from_numpy(x), Ctx(cfg=tcfg))
    assert jcache is None and tcache is None
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)


def _pair(arch, attn_impl, approx):
    jcfg, tcfg = _configs(arch, approx, num_layers=4, attn_impl=attn_impl)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, tmodel, tparams


@pytest.mark.parametrize("arch,attn_impl,approx", [
    pytest.param("mamba2-130m", "xla", False, id="mamba2-xla"),
    pytest.param("mamba2-130m", "pallas", False, id="mamba2-pallas"),
    pytest.param("mamba2-130m", "xla", True, id="mamba2-bitexact-mlp"),
    pytest.param("recurrentgemma-2b", "xla", False, id="recurrentgemma-xla"),
    pytest.param("recurrentgemma-2b", "pallas", False, id="recurrentgemma-pallas"),
    pytest.param("recurrentgemma-2b", "xla", True, id="recurrentgemma-bitexact-mlp"),
])
def test_prefill_and_teacher_forced_decode_logits_match_reference(arch, attn_impl, approx,
                                                                  monkeypatch):
    """Reduced mamba2-130m (four SSD layers) and recurrentgemma-2b (one
    scanned group and one remainder RG-LRU layer; the window of 8 binds
    within 13 + 3 tokens): prefill logits and then ``MODEL_STEPS``
    teacher-forced decode steps' logits, within ``TOL``."""
    jmodel, jparams, tmodel, tparams = _pair(arch, attn_impl, approx)
    kinds = [type(c).__name__ for c in tmodel.init_caches(1, 4, torch.float32, "cpu")]
    assert kinds == {"mamba2-130m": ["SSDCache"] * 4,
                     "recurrentgemma-2b": ["RGLRUCache", "RGLRUCache", "KVCache",
                                           "RGLRUCache"]}[arch]
    recorded = _force_reference_gemms(monkeypatch) if approx else []
    toks = np.random.default_rng(1).integers(0, 256, (B, S + MODEL_STEPS)).astype(np.int32)
    cap = S + MODEL_STEPS
    jcache, jlogits = jax_prefill_step(jmodel, cap)(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    with torch.inference_mode():
        tcache, tlogits = make_prefill_step(tmodel, cap)(
            tparams, {"tokens": torch.from_numpy(toks[:, :S]).long()})
    assert not recorded
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    jdec, tdec = jax_decode_step(jmodel), make_decode_step(tmodel)
    for step in range(MODEL_STEPS):
        tok, p = toks[:, S + step:S + step + 1], np.full((B,), S + step, np.int32)
        jlogits, jcache = jdec(jparams, jcache, jnp.asarray(tok), jnp.asarray(p))
        with torch.inference_mode():
            tlogits, tcache = tdec(tparams, tcache, torch.from_numpy(tok).long(),
                                   torch.from_numpy(p).long())
        assert not recorded
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL,
                                   err_msg=f"decode step {step}")


@pytest.mark.parametrize("s", [1, 2, 5, 64, 100])
def test_linear_scan_equals_the_step_by_step_recurrence(s):
    """The log-depth scan against ``h_t = a_t h_{t-1} + b_t`` step by step,
    in float64, with ``b`` wider than ``a`` (the SSD's inter-chunk states)."""
    g = torch.Generator().manual_seed(s)
    a = torch.rand((3, s, 4), generator=g, dtype=torch.float64)
    b = torch.randn((3, s, 4, 2), generator=g, dtype=torch.float64)
    h, want = torch.zeros((3, 4, 2), dtype=torch.float64), []
    for t in range(s):
        h = a[:, t, :, None] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b, dim=1), torch.stack(want, 1),
                               rtol=1e-12, atol=1e-12)


def test_softplus_and_conv_follow_the_reference():
    """softplus is ``logaddexp(x, 0)`` past ``F.softplus``'s threshold too;
    the causal conv sums in the input's dtype in the reference's order."""
    x = np.array([-30.0, -1.0, 0.0, 1.0, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_allclose(rglru.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-7, atol=0)
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((2, 6, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    bias = rng.standard_normal((5,)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 5)).astype(np.float32)
    to_bf16 = lambda a: jnp.asarray(a, jnp.bfloat16)
    jout, jnew = jax_rglru._causal_conv(to_bf16(xs), to_bf16(w), to_bf16(bias), to_bf16(cache))
    tout, tnew = rglru._causal_conv(*(torch.from_numpy(a).to(torch.bfloat16)
                                      for a in (xs, w, bias, cache)))
    assert tout.dtype == torch.bfloat16
    np.testing.assert_array_equal(tnew.float().numpy(), np.asarray(jnew, np.float32))
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout, np.float32),
                               rtol=2**-7, atol=2**-7)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_bf16_model_keeps_the_reference_float32_leaves(arch):
    """In a bfloat16 model the reference keeps the RG-LRU's Lambda and the
    SSD's A, D and dt bias float32; the loader and the port's own init do
    too, and the caches' states are float32 beside bf16 conv inputs."""
    jcfg = jax_get_config(arch).reduced(dtype="bfloat16", num_layers=4)
    tcfg = get_config(arch).reduced(dtype="bfloat16", num_layers=4)
    tree = jax.tree_util.tree_map(np.asarray, jax_build_model(jcfg).init_params(
        jax.random.PRNGKey(1)))
    names = {"mamba2-130m": ("ssm_a", "ssm_d", "dt_bias"), "recurrentgemma-2b": ("lru_a",)}[arch]
    mixer = "ssd" if arch == "mamba2-130m" else "rglru"
    for params in (from_jax_params(tree, tcfg, device="cpu"),
                   build_model(tcfg).init_params(0, device="cpu")):
        for block in params.layers:
            mix = getattr(block, mixer)
            if mix is None:
                continue
            assert all(mix[n].dtype == torch.float32 for n in names)
            assert mix["conv_w"].dtype == mix["out_proj"].dtype == torch.bfloat16
    for cache in build_model(tcfg).init_caches(2, 8, torch.bfloat16, "cpu"):
        if not hasattr(cache, "k"):
            assert cache.conv.dtype == torch.bfloat16 and cache[1].dtype == torch.float32


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_seeded_init_has_the_reference_scales(arch):
    """The port's own init (used on the card): std d^-1/2 per projection,
    the conv at 0.1, and the reference's fixed Lambda, A, D and dt bias."""
    cfg = get_config(arch).reduced(d_model=256, num_layers=4)
    jcfg = jax_get_config(arch).reduced(d_model=256, num_layers=4)
    params = build_model(cfg).init_params(0, device="cpu")
    tree = jax_build_model(jcfg).init_params(jax.random.PRNGKey(0))
    mixer = "ssd" if arch == "mamba2-130m" else "rglru"
    mix, want = params.layers[0], tree["scan"]["sub0"][mixer]
    mix = {k: v.detach() for k, v in getattr(mix, mixer).items()}
    proj = "in_proj" if mixer == "ssd" else "in_x"
    assert abs(float(mix[proj].std()) * 256**0.5 - 1.0) < 0.05
    assert abs(float(mix["conv_w"].std()) / 0.1 - 1.0) < 0.1
    for name in ("ssm_a", "ssm_d", "dt_bias", "lru_a"):
        if name in mix:
            np.testing.assert_allclose(mix[name].numpy(), np.asarray(want[name])[0],
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_training_the_recurrent_families_raises(arch, capsys):
    """``make_train_step`` and the train CLI train both families (the name
    is kept from when both refused).  One step of a bf16 model: autograd
    reaches both scans and every float32 leaf the reference keeps (Lambda;
    A, D and dt bias), whose gradients are float32, finite and nonzero, and
    AdamW keeps them float32; then the CLI runs two steps on the CPU."""
    from repro_torch.launch import train as train_cli
    from repro_torch.models.registry import reference_leaves
    from repro_torch.train import steps

    cfg = get_config(arch).reduced(dtype="bfloat16", num_layers=4)
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=4, warmup_steps=1)
    state = steps.init_train_state(model, tcfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 17)))
    params = state.params
    loss, _ = steps.loss_fn(params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, 0, model)
    loss.backward()
    grads = dict(zip((leaf.names for leaf in reference_leaves(params)),
                     steps._grads(params, reference_leaves(params), {"tokens": toks})))
    names = {"mamba2-130m": ("ssm_a", "ssm_d", "dt_bias"), "recurrentgemma-2b": ("lru_a",)}[arch]
    f32 = [(n, g) for ns, g in grads.items() for n in ns[:1] if n.rsplit(".", 1)[-1] in names]
    assert {n.rsplit(".", 1)[-1] for n, _ in f32} == set(names)
    for n, g in f32:
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()) and g.abs().max() > 0, n
    params.zero_grad(set_to_none=True)
    state, metrics = make_train_step(model, tcfg)(state, {"tokens": toks[:, :-1],
                                                          "labels": toks[:, 1:]})
    assert np.isfinite(float(metrics["loss"])) and int(state.step) == 1
    for n, p in state.params.named_parameters():
        if n.rsplit(".", 1)[-1] in names:
            assert p.dtype == torch.float32, n
    train_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2", "--batch",
                    "2", "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke params=" in out and "loss " in out
