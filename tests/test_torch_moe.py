"""The port's MoE feed-forward against the JAX package's ``moe_ffn``.

The same numpy inputs and the reference's own ``init_moe`` weights go
through both packages in float32, at reduced granite-moe-1b-a400m (4
experts, top-2, ``moe_d_ff`` 32, capacity factor 1.25) and reduced
kimi-k2-1t-a32b (capacity factor 1.0, so assignments are dropped), on the
single-device path.  What is held:

- **routing equal**: the top-k expert ids (recorded from the reference's
  ``jax.lax.top_k``), and every assignment's destination slot, or its
  being dropped, read off the (E, C, d) buffer the reference hands its
  expert GEMMs (each token row is distinct, so a slot names its token);
  the port's buffer must equal the reference's bit for bit.  The smallest
  gap between a token's k-th and (k+1)-th probability is reported (a near
  tie could route differently under another rounding of the softmax; the
  seed is not chosen to avoid one);
- **the output** within ``rtol = atol = 1e-5`` (float32 sums in another
  order), **aux** within 1e-6;
- **capacity**: Python's half-to-even ``round`` (2.5 -> 2, 7.5 -> 8);
- **every engine mode through the ``moe`` target**: each deterministic
  mode by value, each expert GEMM of the port checked to get the
  reference's input within 1e-5 and then fed it (an ulp can cross an 8-bit
  quantizer boundary, as in ``test_torch_model.py``); the stochastic
  ``inject`` by being finite and by the moments of its deviation from
  ``fakequant`` (a port of ``tests/test_engine.py``'s MoE case).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import apply_approx as jax_apply_approx
from repro.configs.registry import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models.layers import Ctx as JaxCtx
from repro_torch.configs.registry import apply_approx, get_config
from repro_torch.models import moe
from repro_torch.models.layers import Ctx

TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = 1e-6
ARCHS = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b")


def _configs(arch, **over):
    return jax_get_config(arch).reduced(**over), get_config(arch).reduced(**over)


def _weights(jcfg, seed=0):
    """The reference's ``init_moe`` weights (float32 at reduced), as numpy."""
    p = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def _input(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _run_reference(jcfg, weights, x, monkeypatch, rng=None):
    """(out, aux, top-k expert ids, the expert GEMMs' inputs) of the
    reference's ``moe_ffn``."""
    topk, gemm_in = [], []
    real_topk, real_gemm = jax.lax.top_k, jax_moe._expert_gemm

    def record_topk(p, k):
        out = real_topk(p, k)
        topk.append(np.asarray(out[1]))
        return out

    def record_gemm(xb, w, ctx):
        gemm_in.append(np.array(xb))
        return real_gemm(xb, w, ctx)

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", record_topk)
        m.setattr(jax_moe, "_expert_gemm", record_gemm)
        out, aux = jax_moe.moe_ffn({k: jnp.asarray(v) for k, v in weights.items()},
                                   jnp.asarray(x), JaxCtx(cfg=jcfg, rng=rng))
    return np.asarray(out), float(aux), topk[0], gemm_in


def _run_port(tcfg, weights, x, monkeypatch, *, forced=None, generator=None):
    """(out, aux, routing, the expert GEMMs' inputs) of the port's
    ``moe_ffn``.  With ``forced`` (the reference's GEMM inputs), each expert
    GEMM's input is held to it within ``TOL`` and replaced by it."""
    gemm_in = []
    real_gemm = moe.expert_gemm

    def record_gemm(xb, w, ctx):
        gemm_in.append(xb.detach().numpy().copy())
        if forced is not None:
            want = forced[len(gemm_in) - 1]
            np.testing.assert_allclose(gemm_in[-1], want, **TOL)
            xb = torch.from_numpy(want)
        return real_gemm(xb, w, ctx)

    params = {k: torch.from_numpy(v.copy()) for k, v in weights.items()}
    xt = torch.from_numpy(x)
    routing = moe.route(params["router"], xt.reshape(-1, xt.shape[-1]), tcfg)
    with monkeypatch.context() as m:
        m.setattr(moe, "expert_gemm", record_gemm)
        out, aux = moe.moe_ffn(params, xt, Ctx(cfg=tcfg, generator=generator))
    return out.detach().numpy(), float(aux), routing, gemm_in


def _slots_from_buffer(buf: np.ndarray, x2: np.ndarray) -> dict:
    """{(token, expert): buffer row} read off an (E, C, d) dispatch buffer."""
    e, cap, _ = buf.shape
    slots = {}
    for ex in range(e):
        for c in range(cap):
            row = buf[ex, c]
            if not row.any():
                continue
            (tok,) = np.nonzero((x2 == row).all(axis=1))[0]
            slots[(int(tok), ex)] = ex * cap + c
    return slots


def _min_topk_gap(x, weights, k) -> float:
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, x.shape[-1])) @
                          torch.from_numpy(weights["router"].copy()), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True).values
    return float((top[:, k - 1] - top[:, k]).min())


@pytest.mark.parametrize("b,s", [(2, 8), (3, 5)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, b, s, monkeypatch, record_property):
    jcfg, tcfg = _configs(arch)
    weights = _weights(jcfg, seed=b)
    x = _input(b, s, tcfg.d_model, seed=10 * b + s)
    x2 = x.reshape(-1, tcfg.d_model)
    k, e = tcfg.num_experts_per_tok, tcfg.num_experts
    gap = _min_topk_gap(x, weights, k)
    record_property("min_topk_gap", gap)
    print(f"{arch} B={b} S={s}: smallest k-th vs (k+1)-th probability gap {gap:.3e}")

    want, want_aux, want_expert, want_in = _run_reference(jcfg, weights, x, monkeypatch)
    got, got_aux, r, got_in = _run_port(tcfg, weights, x, monkeypatch)

    np.testing.assert_array_equal(r.expert.numpy(), want_expert,
                                  err_msg=f"top-k ids differ (smallest gap {gap:.3e})")
    assert r.cap == moe.capacity(b * s, k, e, tcfg.capacity_factor) == want_in[0].shape[1]
    np.testing.assert_array_equal(got_in[0], want_in[0])  # the dispatch buffer, bit for bit
    want_slots = _slots_from_buffer(want_in[0], x2)
    sorted_e = r.expert.reshape(-1)[r.order]
    got_slots = {(int(t), int(ex)): int(dst)
                 for t, ex, dst, kept in zip(r.token, sorted_e, r.dest, r.keep) if kept}
    assert got_slots == want_slots
    dropped = int((~r.keep).sum())
    assert dropped == b * s * k - len(want_slots)
    assert bool((r.dest[~r.keep] == e * r.cap).all())
    if tcfg.capacity_factor == 1.0:
        assert dropped > 0  # the case must exercise dropping
    np.testing.assert_allclose(got, want, **TOL)
    assert abs(got_aux - want_aux) <= AUX_TOL, (got_aux, want_aux)


@pytest.mark.parametrize("tokens,k,e,cf,want", [
    (4, 2, 4, 1.25, 2),     # 2.5 -> 2
    (12, 2, 4, 1.25, 8),    # 7.5 -> 8
    (8, 8, 32, 1.25, 2),    # granite's top-8 of 32 at 8 tokens: 2.5 -> 2
    (40, 8, 32, 1.25, 12),  # 12.5 -> 12
    (1, 8, 32, 1.25, 1),    # at least 1
    (4, 2, 4, 8.0, 4),      # at most the tokens
    (6, 2, 4, 1.0, 3),
])
def test_capacity_rounds_half_to_even(tokens, k, e, cf, want):
    assert moe.capacity(tokens, k, e, cf) == want == min(int(max(1, round(tokens * k / e * cf))),
                                                         tokens)


@pytest.mark.parametrize("b,s", [(1, 4), (2, 6)], ids=["2.5", "7.5"])
def test_moe_ffn_at_a_half_capacity_quotient(b, s, monkeypatch):
    """Reduced granite (top-2 of 4, cf 1.25): 4 tokens give 2.5 slots and
    12 give 7.5; both packages round half to even (2, 8)."""
    jcfg, tcfg = _configs("granite-moe-1b-a400m")
    weights = _weights(jcfg, seed=5)
    x = _input(b, s, tcfg.d_model, seed=b + s)
    want, want_aux, want_expert, want_in = _run_reference(jcfg, weights, x, monkeypatch)
    got, got_aux, r, got_in = _run_port(tcfg, weights, x, monkeypatch)
    assert r.cap == want_in[0].shape[1] == {4: 2, 12: 8}[b * s]
    np.testing.assert_array_equal(r.expert.numpy(), want_expert)
    np.testing.assert_array_equal(got_in[0], want_in[0])
    np.testing.assert_allclose(got, want, **TOL)
    assert abs(got_aux - want_aux) <= AUX_TOL


DETERMINISTIC = ("exact", "bitexact", "lowrank", "seqmul", "fakequant")


@pytest.mark.parametrize("mode", DETERMINISTIC)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_deterministic_mode_through_the_moe_target(arch, mode, monkeypatch):
    jcfg, tcfg = _configs(arch)
    jcfg = jax_apply_approx(jcfg, mode=mode, n=8, t=4, targets=("moe",))
    tcfg = apply_approx(tcfg, mode=mode, n=8, t=4, targets=("moe",))
    weights = _weights(jcfg, seed=3)
    x = _input(2, 6, tcfg.d_model, seed=4)
    want, want_aux, _, want_in = _run_reference(jcfg, weights, x, monkeypatch)
    got, got_aux, _, got_in = _run_port(tcfg, weights, x, monkeypatch, forced=want_in)
    assert len(got_in) == len(want_in) == 3
    np.testing.assert_allclose(got, want, **TOL)
    assert abs(got_aux - want_aux) <= AUX_TOL


def test_inject_through_the_moe_target_by_moments(monkeypatch):
    """``inject`` draws its noise from each package's own generator, so it
    is held by moments: over 256 tokens (capacity lifted, nothing dropped)
    the deviation of ``inject``'s output from ``fakequant``'s has the
    reference's mean and spread within 10%, and is finite; the port's
    draws follow the experts in order from one generator, so a seed
    repeats them."""
    jcfg, tcfg = _configs("granite-moe-1b-a400m", capacity_factor=8.0)
    weights = _weights(jcfg, seed=6)
    x = _input(4, 64, tcfg.d_model, seed=7)

    def reference(mode):
        cfg = jax_apply_approx(jcfg, mode=mode, n=8, t=4, targets=("moe",))
        return _run_reference(cfg, weights, x, monkeypatch, rng=jax.random.PRNGKey(3))[0]

    def port(mode, seed=11):
        cfg = apply_approx(tcfg, mode=mode, n=8, t=4, targets=("moe",))
        gen = torch.Generator().manual_seed(seed)
        return _run_port(cfg, weights, x, monkeypatch, generator=gen)[0]

    want = reference("inject") - reference("fakequant")
    got_inject = port("inject")
    got = got_inject - port("fakequant")
    assert got.shape == x.shape and np.isfinite(got_inject).all()
    np.testing.assert_array_equal(port("inject"), got_inject)  # the same seed, the same draws
    assert not np.array_equal(port("inject", seed=12), got_inject)
    assert abs(got.std() / want.std() - 1) < 0.1, (got.std(), want.std())
    assert abs(got.mean() - want.mean()) < 0.1 * want.std(), (got.mean(), want.mean())
    assert abs(np.abs(got).mean() / np.abs(want).mean() - 1) < 0.1
