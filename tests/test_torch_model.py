"""The port's decoder stack against the JAX package on the same weights.

``qwen3-0.6b.reduced()`` is built in both packages; the JAX model's own
parameters are turned into numpy and loaded into the port with
``from_jax_params`` (scanned layer groups, stacked on a leading axis, are
unstacked per layer).  Prefill logits over left-padded prompts with
per-row positions, then several decode steps with per-row positions and
write slots, must agree in float32 within ``rtol=1e-5, atol=1e-5``: the
sums inside matmul and softmax run in another order in the two
frameworks.

With ``bitexact`` at an explicit (n=8, t=4), each approximate GEMM of the
port is checked to receive the reference's input within that tolerance
and is then fed the reference's input itself.  The reason: an input that
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
from repro_torch.models.registry import build_model, from_jax_params
from repro_torch.train.steps import make_decode_step, make_prefill_step

B, S, T, STEPS = 2, 8, 16, 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(approx, **over):
    jcfg, tcfg = jax_get_config("qwen3-0.6b").reduced(**over), get_config("qwen3-0.6b").reduced()
    if approx is not None:
        mode, n, t = approx
        jcfg = jax_apply_approx(jcfg, mode=mode, n=n, t=t)
        tcfg = apply_approx(tcfg, mode=mode, n=n, t=t)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, tmodel, tparams


def _force_reference_inputs(monkeypatch):
    """Record each approximate GEMM input of the JAX model and hand it to
    the port's matching call, after checking the port's own input."""
    import repro.models.layers as jax_layers
    import repro_torch.models.layers as port_layers

    recorded = []
    jax_approx_2d, port_approx_2d = jax_layers._approx_2d, port_layers._approx_2d

    def record(x2, w, ap, key):
        recorded.append(np.array(x2))  # a writable copy
        return jax_approx_2d(x2, w, ap, key)

    def forced(x2, w, ap, generator):
        want = recorded.pop(0)
        np.testing.assert_allclose(x2.numpy(), want, **TOL)
        return port_approx_2d(torch.from_numpy(want), w, ap, generator)

    monkeypatch.setattr(jax_layers, "_approx_2d", record)
    monkeypatch.setattr(port_layers, "_approx_2d", forced)
    return recorded


@pytest.mark.parametrize("approx", [None, ("bitexact", 8, 4)], ids=["exact", "bitexact-8-4"])
def test_prefill_and_decode_logits_match_reference(approx, monkeypatch):
    # the recorder reads concrete inputs, so the approximate case runs the
    # reference unscanned (lax.scan would hand it tracers)
    over = {} if approx is None else {"scan_layers": False}
    jmodel, jparams, tmodel, tparams = _pair(approx, **over)
    recorded = _force_reference_inputs(monkeypatch) if approx is not None else []
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
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
    base = get_config("qwen3-0.6b").reduced()
    hybrid = dataclasses.replace(base, layer_pattern=("rglru", "rglru", "attn_local"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(hybrid).init_params(0, device="cpu")
    moe = dataclasses.replace(base, num_experts=4, num_experts_per_tok=2, moe_d_ff=32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(moe).init_params(0, device="cpu")
    with pytest.raises(KeyError, match="qwen3-0.6b"):
        get_config("recurrentgemma-2b")
