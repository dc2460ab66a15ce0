"""The port's attention gradients against the JAX package, on the CPU.

``jax.grad`` runs through the reference's ``flash_attention`` (its
``custom_vjp``: ``_dq_kernel`` and ``_dkv_kernel`` in interpret mode, as
the JAX package's own tests run them) and through
``approx_flash_attention`` (straight-through: the same exact backward on
the approximate forward's ``(o, lse)``).  On CPU tensors the port runs its
plain versions: the forward with lse and ``flash_attention_bwd_plain``,
the FlashAttention-2 recompute.  The same numpy inputs and output
cotangent, made from a seed, go to both.

Tolerances:
- float32 inputs: rtol/atol 1e-5 on dq, dk, dv (float32 sums in another
  order; lse itself agrees to a few ulps);
- bfloat16 inputs: the gradients come back in bfloat16 on both sides, and
  a float32 value that differs in its last bits can round to the
  neighbouring bfloat16 value, so each gradient is held to one bfloat16
  ulp (rtol 2^-7) plus atol 1e-5 for values near 0;
- the approximate forward (bitexact, lowrank): its probabilities are
  quantized, and an ulp of exp can move one across a rounding boundary of
  ``p_int``, moving o and with it dd by a quantum; so the gradients are
  held within 1e-4 * max|want| (the train-step tolerance) per tensor.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.approx_attention import approx_flash_attention as jax_approx
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import approx_attention, flash_attention

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0**-7, atol=1e-5)


def _inputs(b=2, s=32, t=32, h=4, kv=2, hd=16, seed=0, amp=0.5, pad=0):
    """q/k/v, positions and an output cotangent.  With ``t > s`` the keys
    are a cache whose tail past the prompt is unwritten (``k_pos = -1``);
    ``pad`` left-pads row 1: its first ``pad`` queries have negative
    positions and no allowed slot at all."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, h, hd)) * amp).astype(np.float32)
    k = (rng.standard_normal((b, t, kv, hd)) * amp).astype(np.float32)
    v = (rng.standard_normal((b, t, kv, hd)) * amp).astype(np.float32)
    do = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    shift = np.zeros((b, 1), np.int32)
    shift[1] = pad
    q_pos = (np.arange(s, dtype=np.int32)[None] - shift).astype(np.int32)
    jj = np.arange(t, dtype=np.int32)[None].repeat(b, 0)
    k_pos = np.where((jj >= shift) & (jj < s), jj - shift, -1).astype(np.int32)
    return q, k, v, q_pos, k_pos, do


def _jax_grads(fn, q, k, v, do, dtype):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(fn, *args)
    return np.asarray(out), [np.asarray(g.astype(jnp.float32)) for g in
                            vjp(jnp.asarray(do, out.dtype))]


def _port_grads(fn, q, k, v, do, dtype):
    args = [torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = fn(*args)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [a.grad.to(torch.float32).numpy() for a in args]


def _check_flash(q, k, v, qp, kp, do, *, causal=True, window=None, softcap=None,
                 dtype="float32", block=None):
    scale = q.shape[-1] ** -0.5
    block = block or int(np.gcd(q.shape[1], k.shape[1]))  # the reference tiles divide S, T
    jqp, jkp = jnp.asarray(qp), jnp.asarray(kp)
    want_o, want = _jax_grads(
        lambda a, b, c: jax_flash(a, b, c, jqp, jkp, causal, window, softcap, scale, block,
                                  block, True),
        q, k, v, do, getattr(jnp, dtype))
    tqp, tkp = torch.from_numpy(qp), torch.from_numpy(kp)
    got_o, got = _port_grads(
        lambda a, b, c: flash_attention.flash_attention(a, b, c, tqp, tkp, causal=causal,
                                                        window=window, softcap=softcap,
                                                        scale=scale),
        q, k, v, do, getattr(torch, dtype))
    np.testing.assert_allclose(got_o, want_o, **F32_TOL)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **tol)
    return got, want


VARIANTS = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=8),
    "softcap": dict(causal=True, softcap=5.0),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 2)], ids=["mha", "gqa2", "gqa4"])
def test_flash_attention_grads_match_reference(variant, h, kv):
    _check_flash(*_inputs(h=h, kv=kv, seed=h * 10 + kv), **VARIANTS[variant])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flash_attention_grads_bf16_within_one_ulp(variant):
    _check_flash(*_inputs(seed=7), dtype="bfloat16", **VARIANTS[variant])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_flash_attention_grads_at_head_width_256(variant, dtype):
    """gemma's head width, gemma2-9b's 16 query and 8 KV heads cut to 4 and
    2: the port's autograd (the backward pair's plain version on the CPU)
    against the reference's custom_vjp in interpret mode."""
    _check_flash(*_inputs(h=4, kv=2, hd=256, seed=256), dtype=dtype, **VARIANTS[variant])


def test_flash_attention_grads_with_masked_cache_slots():
    """Keys are a 48-slot cache of which the 32 prompt slots are written."""
    _check_flash(*_inputs(t=48, seed=3))


def test_fully_masked_pad_row_keeps_the_reference_backward():
    """A left-pad query has no allowed slot: lse = NEG_INF, p = 1 on every
    slot, so dv takes that row's do at every slot with weight 1 (not the
    1/T autograd through a softmax would give), and dq of that row is 0.
    The port's plain backward must reproduce the reference here."""
    q, k, v, qp, kp, do = _inputs(t=48, seed=5, pad=5)
    got, want = _check_flash(q, k, v, qp, kp, do)
    assert np.all(got[0][1, :5] == 0)  # dq of the pad rows
    # the pad rows' share of dv: the sum of their do at every slot, weight 1
    do_pad = do[1, :5].reshape(5, 2, 2, -1).sum(axis=(0, 2))  # (KV, hd)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tqp, tkp = torch.from_numpy(qp), torch.from_numpy(kp)
    o, lse = flash_attention.flash_attention_fwd(tq, tk, tv, tqp, tkp, scale=0.25,
                                                 with_lse=True)
    assert np.all(lse[1, :, :5].numpy() == np.float32(flash_attention.NEG_INF))
    # the same backward with the pad rows' cotangent alone
    only_pad = np.zeros_like(do)
    only_pad[1, :5] = do[1, :5]
    _, _, dv = flash_attention.flash_attention_bwd_plain(
        tq, tk, tv, tqp, tkp, o, lse, torch.from_numpy(only_pad), scale=0.25)
    np.testing.assert_allclose(dv[1].numpy(), np.broadcast_to(do_pad, dv[1].shape), **F32_TOL)
    # autograd through the plain softmax would give 1/T of that instead
    w = torch.from_numpy(v).requires_grad_()
    out = flash_attention.attend(tq, tk, w, tqp, tkp, causal=True, window=None, softcap=None,
                                 scale=0.25)
    out.backward(torch.from_numpy(only_pad))
    np.testing.assert_allclose(w.grad[1].numpy() * 48, dv[1].numpy(), rtol=1e-5)


@pytest.mark.parametrize("mode", ["bitexact", "lowrank"])
def test_approx_attention_grads_are_the_exact_backward_on_approx_residuals(mode):
    q, k, v, qp, kp, do = _inputs(t=48, seed=11, pad=3)
    scale = q.shape[-1] ** -0.5
    jqp, jkp = jnp.asarray(qp), jnp.asarray(kp)
    want_o, want = _jax_grads(
        lambda a, b, c: jax_approx(a, b, c, jqp, jkp, mode, 8, 4, True, 8, True, None, None,
                                   scale, 16, 16, True),
        q, k, v, do, jnp.float32)
    tqp, tkp = torch.from_numpy(qp), torch.from_numpy(kp)
    got_o, got = _port_grads(
        lambda a, b, c: approx_attention.approx_flash_attention(
            a, b, c, tqp, tkp, mode, 8, 4, True, 8, causal=True, scale=scale, bk=16),
        q, k, v, do, torch.float32)
    quantum = np.abs(v).max() / 255
    assert np.abs(got_o - want_o).max() <= quantum
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = np.abs(g - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err, np.abs(w).max())
    # and it is the exact backward on the approximate forward's residuals
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = approx_attention.approx_attention_plain(tq, tk, tv, tqp, tkp, mode=mode, scale=scale,
                                                     bk=16, with_lse=True)
    exact = flash_attention.flash_attention_bwd_plain(tq, tk, tv, tqp, tkp, o, lse,
                                                      torch.from_numpy(do), scale=scale)
    for g, e in zip(got, exact):
        np.testing.assert_array_equal(g, e.numpy())


def test_no_lse_without_a_gradient():
    """Serving (no gradient asked) takes the forward alone: the same o."""
    q, k, v, qp, kp, _ = _inputs(seed=2)
    args = [torch.from_numpy(x) for x in (q, k, v, qp, kp)]
    plain = flash_attention.flash_attention(*args, scale=0.25)
    assert plain.grad_fn is None
    o, lse = flash_attention.flash_attention_fwd(*args, scale=0.25, with_lse=True)
    assert torch.equal(o, plain) and lse.shape == (2, 4, 32)


# ------------------------------------------ the backward kernels' tile plan
def _skip_case(name):
    """Positions (B = 2, S query rows, T slots) of each case the skip rule
    must get right; returns (q_pos, k_pos, causal, window)."""
    b, s = 2, 200
    jj = np.arange(s, dtype=np.int32)[None].repeat(b, 0)
    if name == "causal":
        return jj, jj.copy(), True, None
    if name == "window 24":
        return jj, jj.copy(), True, 24
    if name == "window 24, not causal":
        return jj, jj.copy(), False, 24
    if name == "left pad 5":
        shift = np.array([[0], [5]], np.int32)
        return jj - shift, np.where(jj >= shift, jj - shift, -1).astype(np.int32), True, None
    if name == "serve cache":  # a 48-slot cache of which the 32 prompt slots are written
        qj = np.arange(32, dtype=np.int32)[None].repeat(b, 0)
        shift = np.array([[0], [5]], np.int32)
        kj = np.arange(48, dtype=np.int32)[None].repeat(b, 0)
        kp = np.where((kj >= shift) & (kj < 32), kj - shift, -1).astype(np.int32)
        return qj - shift, kp, True, None
    # not monotone: rows reversed inside every 8, slots shuffled inside every 64
    rng = np.random.default_rng(0)
    qp = jj.reshape(b, -1, 8)[:, :, ::-1].reshape(b, s).copy()
    kp = jj.copy()
    for i in range(0, s, 64):
        kp[:, i:i + 64] = rng.permutation(kp[0, i:i + 64])
    return qp, kp, True, None


SKIP_CASES = ["causal", "window 24", "window 24, not causal", "left pad 5", "serve cache",
              "not monotone"]


@pytest.mark.parametrize("case", SKIP_CASES)
def test_skipped_backward_tiles_add_exactly_nothing(case):
    """Every tile the kernels' plan skips has p == 0 and ds == 0 exactly on
    the plain backward (dq: ds; dk/dv: both), so skipping it changes no
    bit; a query tile holding a pad row (lse = NEG_INF, p = 1 on masked
    slots) is never skipped in dk/dv.  Each case skips some tiles."""
    qp, kp, causal, window = _skip_case(case)
    b, s, t, h, kv, hd = 2, qp.shape[1], kp.shape[1], 4, 2, 16
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    do = torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(np.float32))
    tqp, tkp = torch.from_numpy(qp), torch.from_numpy(kp)
    kw = dict(causal=causal, window=window, softcap=None, scale=hd**-0.5)
    o, lse = flash_attention.attend(q, k, v, tqp, tkp, with_lse=True, **kw)
    dd = torch.einsum("bshd,bshd->bhs", do, o)
    p, ds = flash_attention.bwd_probs(q, k, v, tqp, tkp, lse, do, dd, **kw)
    dq_live, dkv_live = flash_attention.bwd_tile_plan(tqp, tkp, lse, causal=causal, window=window)
    fa = flash_attention
    assert dq_live.shape == (b, -(-s // fa.DQ_ROWS), -(-t // fa.DQ_KEYS))
    assert dkv_live.shape == (b, h, -(-t // fa.KV_KEYS), -(-s // fa.KV_ROWS))
    for bi, qt, kt in (~dq_live).nonzero().tolist():
        tile = ds[bi, :, qt * fa.DQ_ROWS:(qt + 1) * fa.DQ_ROWS, kt * fa.DQ_KEYS:(kt + 1) * fa.DQ_KEYS]
        assert bool((tile == 0).all()), ("dq", bi, qt, kt)
    for bi, hi, kt, qt in (~dkv_live).nonzero().tolist():
        rows = slice(qt * fa.KV_ROWS, (qt + 1) * fa.KV_ROWS)
        slots = slice(kt * fa.KV_KEYS, (kt + 1) * fa.KV_KEYS)
        assert bool((p[bi, hi, rows, slots] == 0).all()), ("p", bi, hi, kt, qt)
        assert bool((ds[bi, hi, rows, slots] == 0).all()), ("ds", bi, hi, kt, qt)
    pad_rows = lse == np.float32(fa.NEG_INF)  # (B, H, S)
    for bi, hi, r in pad_rows.nonzero().tolist():
        assert bool(dkv_live[bi, hi, :, r // fa.KV_ROWS].all()), ("pad", bi, hi, r)
    assert bool(pad_rows.any()) == (case in ("left pad 5", "serve cache"))
    assert not bool(dq_live.all())  # the serve cache: its unwritten tail
    assert s <= fa.KV_KEYS or not bool(dkv_live.all())


BWD_SHAPES = {  # (B, S, T, H, KV): the train shape, S = T = 1024, the serve cache
    "train": (8, 128, 128, 16, 8), "long": (1, 1024, 1024, 16, 8), "serve": (4, 32, 48, 16, 8),
}


@pytest.mark.parametrize("shape", sorted(BWD_SHAPES))
@pytest.mark.parametrize("hd", flash_attention.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_backward_launch_plans_fit_the_card(dtype, hd, shape):
    """Every built head width and dtype: the shared memory of a block fits
    the 227 KiB a block may use, and the grid and block fit CUDA's limits."""
    b, s, t, h, kv = BWD_SHAPES[shape]
    for kernel in ("dq", "dkv"):
        plan = flash_attention.launch_plan(kernel, b, s, t, h, kv, hd, dtype)
        assert plan.smem <= 227 * 1024 == flash_attention.SMEM_PER_BLOCK
        assert plan.smem == flash_attention.smem_bytes(kernel, hd, dtype, s, t, h // kv)
        assert 1 <= plan.grid[0] < 2**31 and 1 <= plan.grid[1] <= 65535
        assert 1 <= plan.grid[2] <= 65535
        assert plan.threads % 32 == 0 and plan.threads <= 1024


def test_backward_launch_plans_at_the_train_and_long_shapes():
    """dq: (S/64) H B blocks of four warps, two resident per SM; dk/dv:
    (T/64) KV B blocks of two warp groups (bf16), one per SM: 128 blocks
    at the train shape and at S = T = 1024 for 132 SMs."""
    fa = flash_attention
    bf = torch.bfloat16
    assert fa.launch_plan("dq", 8, 128, 128, 16, 8, 128, bf) == fa.BwdPlan((2, 16, 8), 128, 87_300)
    assert fa.launch_plan("dkv", 8, 128, 128, 16, 8, 128, bf) == fa.BwdPlan((2, 8, 8), 256, 171_524)
    assert fa.launch_plan("dq", 1, 1024, 1024, 16, 8, 128, bf).grid == (16, 16, 1)
    assert fa.launch_plan("dkv", 1, 1024, 1024, 16, 8, 128, bf).grid == (16, 8, 1)
    assert 2 * fa.launch_plan("dq", 1, 1024, 1024, 16, 8, 128, bf).smem <= 228 * 1024
    f32 = fa.launch_plan("dkv", 8, 128, 128, 16, 8, 128, torch.float32)
    assert f32.threads == 128 and f32.smem <= fa.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="head_dim"):
        fa.launch_plan("dq", 1, 8, 8, 2, 1, 48, bf)
