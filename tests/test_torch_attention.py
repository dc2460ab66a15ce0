"""The port's attention kernels against the JAX package, on the CPU.

On CPU tensors each wrapper of ``repro_torch.kernels`` runs its plain
version; the JAX kernels run in interpret mode, as the JAX package's own
tests run them.  The same numpy inputs, made from a seed, go to both.

Tolerances:
- ``flash_attention`` / ``flash_decode``: 2e-5, the reference's own flash
  tolerance (``tests/test_flash_kernel.py``): float32 sums in another order.
- ``approx_flash_attention``: ``s_int`` of bitexact is an exact integer on
  both sides and is held bit-equal.  The outputs differ where ``exp``
  differs in the last bits between the two frameworks.  That moves l, the
  softmax sum, by an ulp.  Where it moves a ``p_int = round(p * (2^n - 1))``
  across a rounding boundary, the output moves by up to one quantum,
  max|v| / (2^n - 1).  So every output is held within one quantum, and
  99% of them within 1e-5.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import approx_attention as jax_approx
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention import flash_decode as jax_flash_decode
from repro_torch.kernels import approx_attention, flash_attention

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


def _inputs(b=2, s=64, t=64, h=4, kv=2, hd=32, seed=0, amp=0.5):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, h, hd)) * amp).astype(np.float32)
    k = (rng.standard_normal((b, t, kv, hd)) * amp).astype(np.float32)
    v = (rng.standard_normal((b, t, kv, hd)) * amp).astype(np.float32)
    q_pos = np.tile(np.arange(s, dtype=np.int32) + (t - s), (b, 1))
    k_pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    return q, k, v, q_pos, k_pos


# ------------------------------------------------------------ flash forward
CASES = [
    dict(causal=True, window=None, softcap=None),
    dict(causal=True, window=16, softcap=None),
    dict(causal=True, window=None, softcap=20.0),
    dict(causal=False, window=None, softcap=None),
]


def _check_forward(q, k, v, qp, kp, *, causal, window, softcap):
    scale = q.shape[-1] ** -0.5
    want = jax_flash_attention(*map(jnp.asarray, (q, k, v, qp, kp)), causal, window, softcap,
                               scale, 32, 32, True)
    got = flash_attention.flash_attention(*map(_t, (q, k, v, qp, kp)), causal=causal,
                                          window=window, softcap=softcap, scale=scale)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASES, ids=["causal", "window", "softcap", "bidirectional"])
def test_flash_attention_matches_reference(case):
    _check_forward(*_inputs(), **case)


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 1), (8, 2)])
def test_flash_attention_gqa_by_head_index(h, kv):
    _check_forward(*_inputs(h=h, kv=kv, seed=h * 10 + kv), **CASES[0])


def test_flash_attention_masked_cache_slots():
    """k_pos = -1 marks unwritten cache slots; they never attend."""
    q, k, v, qp, kp = _inputs(s=16, t=64)
    kp = np.where(kp < 40, kp, -1).astype(np.int32)
    qp = np.minimum(qp, 39).astype(np.int32)
    _check_forward(q, k, v, qp, kp, **CASES[2])


def test_flash_attention_bf16_inputs_compute_in_float32():
    q, k, v, qp, kp = _inputs(seed=3)
    bf = [np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (q, k, v)]
    want = jax_flash_attention(*map(jnp.asarray, (*bf, qp, kp)), True, None, None, 0.25,
                               32, 32, True)
    got = flash_attention.flash_attention(
        *(_t(x.astype(np.float32)).to(torch.bfloat16) for x in (q, k, v)), _t(qp), _t(kp),
        scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------- flash decode
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 1), (8, 2)])
@pytest.mark.parametrize("window,softcap", [(None, None), (16, None), (None, 20.0)])
def test_flash_decode_matches_reference(h, kv, window, softcap):
    """Per-row decode positions and -1 (unwritten) cache slots."""
    q, k, v, _, kp = _inputs(b=3, s=1, t=64, h=h, kv=kv, seed=h + kv)
    q = q[:, 0]
    valid = np.array([40, 17, 64])
    kp = np.where(kp < valid[:, None], kp, -1).astype(np.int32)
    kp[1, :5] = -1  # a left-padded row
    qp = (valid - 1).astype(np.int32)
    scale = q.shape[-1] ** -0.5
    want = jax_flash_decode(*map(jnp.asarray, (q, k, v, qp, kp)), window=window,
                            softcap=softcap, scale=scale, bk=16, interpret=True)
    got = flash_attention.flash_decode(*map(_t, (q, k, v, qp, kp)), window=window,
                                       softcap=softcap, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------ approximate attention
def _approx_inputs(seed):
    """Window + softcap, row 1's first 8 slots masked (a whole key block at
    bk = 8), and its first 3 queries left pads with no allowed slot."""
    q, k, v, qp, kp = _inputs(b=2, s=16, t=32, h=4, kv=2, hd=16, seed=seed, amp=1.0)
    kp[1, :8] = -1
    kp[1, 8:] -= 8
    qp[1] -= 8
    qp[1, :3] = -1
    return q, k, v, qp, kp


@pytest.mark.parametrize("bk", [16, 8])
@pytest.mark.parametrize("mode", ["bitexact", "lowrank"])
def test_approx_attention_matches_blockwise_reference(mode, bk):
    q, k, v, qp, kp = _approx_inputs(seed=bk)
    kw = dict(mode=mode, n=8, t=4, rank=4, causal=True, window=12, softcap=20.0,
              scale=0.25, bk=bk)
    want = np.asarray(jax.jit(functools.partial(jax_approx.approx_attention_reference,
                                                bq=8, **kw))(
        *map(jnp.asarray, (q, k, v, qp, kp))))
    got = approx_attention.approx_flash_attention(*map(_t, (q, k, v, qp, kp)), **kw).numpy()
    assert np.isfinite(got).all()
    quantum = np.abs(v).max() / 255
    np.testing.assert_allclose(got, want, rtol=0, atol=quantum)
    assert (np.abs(got - want) <= 1e-5).mean() >= 0.99


def test_approx_attention_key_block_is_part_of_the_function():
    """bk = 16 and bk = 8 give other integers, and each version follows
    the block it is given."""
    q, k, v, qp, kp = _approx_inputs(seed=5)
    outs = {}
    for bk in (16, 8):
        kw = dict(mode="bitexact", n=8, t=4, causal=True, scale=0.25, bk=bk)
        want = np.asarray(jax_approx.approx_attention_reference(
            *map(jnp.asarray, (q, k, v, qp, kp)), **kw))
        got = approx_attention.approx_flash_attention(*map(_t, (q, k, v, qp, kp)), **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=np.abs(v).max() / 255)
        outs[bk] = got.numpy()
    assert np.abs(outs[16] - outs[8]).max() > 1e-3


def test_bitexact_score_integers_are_bit_equal():
    """``s_int`` and ``av_int`` of one bitexact tile pair, from the same
    quantized operands, equal the reference's exactly."""
    from repro.engine import artifacts as jax_artifacts
    from repro_torch.engine import artifacts

    rng = np.random.default_rng(11)
    n, t = 8, 4
    mq, mk, mv = (rng.integers(0, 256, shape).astype(np.int32)
                  for shape in ((8, 16), (16, 16), (16, 16)))
    sq, sk, sv = (rng.choice([-1.0, 0.0, 1.0], shape).astype(np.float32)
                  for shape in ((8, 16), (16, 16), (16, 16)))
    p_int = rng.integers(0, 256, (8, 16)).astype(np.int32)
    lut = jnp.asarray(jax_artifacts.product_lut(n, t, True).reshape(-1), jnp.float32)
    js, jav = jax_approx._bitexact_tile(*map(jnp.asarray, (mq, sq, mk, sk, mv, sv)), lut, n=n)
    tlut = artifacts.product_lut_u16(n, t, True, torch.device("cpu"))
    tlut = (tlut.view(torch.int16).to(torch.int64) & 0xFFFF).to(torch.float32)
    ts, tav = approx_attention.bitexact_tile(
        _t(mq).long(), _t(sq), _t(mk).long(), _t(sk), _t(mv).long(), _t(sv), tlut, n=n)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tav(_t(p_int).long()).numpy(),
                                  np.asarray(jav(jnp.asarray(p_int))))


def test_bf16_quantizer_scale_is_bit_equal():
    """At full width q/k/v are bf16 and the reference calibrates in bf16;
    the port's scale and integers equal it bit for bit."""
    x = np.random.default_rng(2).standard_normal((3, 5, 4, 16)).astype(np.float32) * 1.7
    xb = jnp.asarray(x, jnp.bfloat16)
    jmag, jsign, jval, jscale = jax_approx._quant_signed(xb, 8)
    tmag, tsign, tval, tscale = approx_attention.quant_signed(
        _t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16), 8)
    assert tscale.dtype == torch.float32
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(tmag.numpy(), np.asarray(jmag).astype(np.int32))
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    # and the bf16 scale is not the float32 one
    _, _, _, f32_scale = jax_approx._quant_signed(jnp.asarray(x), 8)
    assert np.asarray(f32_scale) != np.asarray(jscale)


def test_validate_attn_mode():
    approx_attention.validate_attn_mode("lowrank", 8)
    with pytest.raises(ValueError, match="supports modes"):
        approx_attention.validate_attn_mode("seqmul", 8)
    with pytest.raises(ValueError, match="n <= 8"):
        approx_attention.validate_attn_mode("bitexact", 9)
    assert approx_attention.attn_tiles("bitexact") == jax_approx.attn_tiles("bitexact")
    assert approx_attention.attn_tiles("lowrank") == jax_approx.attn_tiles("lowrank")


# ------------------------------------------------------ the attention layer
def _layer_pair(approx=None):
    from repro.configs.base import ApproxConfig as JApprox
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import attention as jax_attention
    from repro_torch.configs.base import ApproxConfig, ModelConfig

    fields = dict(name="tiny", family="test", d_model=32, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=64, vocab_size=128, num_layers=1, attn_impl="pallas",
                  use_qk_norm=True, dtype="float32")
    jcfg, tcfg = JModelConfig(**fields), ModelConfig(**fields)
    if approx is not None:
        jcfg = dataclasses.replace(jcfg, approx=JApprox(**approx))
        tcfg = dataclasses.replace(tcfg, approx=ApproxConfig(**approx))
    jparams = jax_attention.init_attn(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tparams = {k: _t(np.asarray(v)) for k, v in jparams.items()}
    return jcfg, tcfg, jparams, tparams


def test_attention_layer_pallas_prefill_and_decode_match_reference():
    """Prefill into a cache at per-row write offsets (row 1 left-padded),
    then decode steps, through flash_attention and flash_decode."""
    from repro.models import attention as jax_attention
    from repro.models.layers import Ctx as JCtx
    from repro_torch.models import attention
    from repro_torch.models.layers import Ctx

    jcfg, tcfg, jparams, tparams = _layer_pair()
    b, s, t = 2, 8, 16
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, s, 32)).astype(np.float32)
    pos = np.stack([np.arange(s), np.arange(s) - 3]).astype(np.int32)
    at = np.array([0, 2], np.int32)
    jcache = jax_attention.init_kv_cache(jcfg, b, t, jnp.float32)
    tcache = attention.init_kv_cache(tcfg, b, t, torch.float32, "cpu")
    jout, jcache = jax_attention.attention(jparams, jnp.asarray(x), jnp.asarray(pos),
                                           JCtx(cfg=jcfg), cache=jcache,
                                           cache_pos=jnp.asarray(at))
    tout, tcache = attention.attention(tparams, _t(x), _t(pos), Ctx(cfg=tcfg), cache=tcache,
                                       cache_pos=_t(at))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for step in range(3):
        x1 = rng.standard_normal((b, 1, 32)).astype(np.float32)
        p1 = (pos[:, -1:] + 1 + step).astype(np.int32)
        w = (at + s + step).astype(np.int32)
        jout, jcache = jax_attention.attention(jparams, jnp.asarray(x1), jnp.asarray(p1),
                                               JCtx(cfg=jcfg), cache=jcache,
                                               cache_pos=jnp.asarray(w))
        tout, tcache = attention.attention(tparams, _t(x1), _t(p1), Ctx(cfg=tcfg),
                                           cache=tcache, cache_pos=_t(w))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5,
                                   err_msg=f"decode step {step}")


@pytest.mark.parametrize("mode,backend,want", [
    ("lowrank", "auto", "approx_flash_attention"),
    ("bitexact", "auto", "approx_flash_attention"),
    ("bitexact", "reference", "flash_attention"),
    ("inject", "auto", "flash_attention"),
])
def test_attention_layer_routes_like_the_reference(mode, backend, want, monkeypatch):
    """Prefill goes to the approximate kernel exactly when the reference's
    does (attn targeted, bitexact/lowrank, backend not reference), with
    the reference's key block; decode always goes to flash_decode."""
    from repro_torch.models import attention
    from repro_torch.models.layers import Ctx

    _, tcfg, _, tparams = _layer_pair(dict(enabled=True, mode=mode, n=8, t=4, rank=4,
                                           targets=("attn",), backend=backend))
    calls = []
    for name in ("approx_flash_attention", "flash_attention", "flash_decode"):
        real = getattr(attention, name)

        def spy(*args, _name=name, _real=real, **kw):
            calls.append((_name, kw.get("bk")))
            return _real(*args, **kw)

        monkeypatch.setattr(attention, name, spy)
    x = torch.randn((2, 8, 32), generator=torch.Generator().manual_seed(0))
    pos = torch.arange(8).expand(2, 8)
    cache = attention.init_kv_cache(tcfg, 2, 48, torch.float32, "cpu")
    out, _ = attention.attention(tparams, x, pos, Ctx(cfg=tcfg), cache=cache, cache_pos=0)
    assert torch.isfinite(out).all()
    bk = {"bitexact": 16, "lowrank": 16}.get(mode) if want == "approx_flash_attention" else None
    assert calls == [(want, bk)]
    calls.clear()
    attention.attention(tparams, x[:, :1], pos[:, -1:] + 1, Ctx(cfg=tcfg), cache=cache,
                        cache_pos=torch.full((2,), 8))
    assert calls == [("flash_decode", None)]
