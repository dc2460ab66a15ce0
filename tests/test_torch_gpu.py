"""Each CUDA kernel of the port against its plain version, on the card.

Every test here is marked ``gpu`` and skips without an NVIDIA Hopper
(sm_90) card.  The file imports torch and numpy only, so that it runs
where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances (kernel against plain version, both on the card):
- the integer GEMMs (lut, seqmul, packed): bit-equal;
- ``lowrank_matmul``: max |err| <= 2e-6 * max |want|: the exact part is an
  integer on both sides, the float32 correction is summed in another order;
- ``flash_attention`` / ``flash_decode``: 2e-5, the reference's flash
  tolerance, for float32 sums in another order;
- ``approx_flash_attention``: within one probability quantum, max|v| /
  (2^n - 1), everywhere, and 1e-5 for 99% of the outputs: the sums of l
  (both modes) and of the lowrank scores run in another order, and an ulp
  there can move a ``p_int`` across a rounding boundary;
- the flash backward (dq, dk/dv kernels): within 1e-4 * max|want| per
  output, float32 before the cast (sums of up to T terms in another order);
- the elementwise multiplier (``seqmul_packed``, ``seqmul_words``):
  bit-equal.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper (sm_90) card")
    return torch.device("cuda")


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k**-0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("kernel", ["lut_matmul", "seqmul_matmul", "packed_matmul"])
def test_kernel_bitmatches_plain_version_on_the_card(kernel, card):
    from repro_torch.engine import artifacts
    from repro_torch.engine.modes import quantize_operands
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import seqmul_matmul as sm

    x, w = (torch.from_numpy(a).to(card) for a in _operands(33, 300, 70, seed=1))
    (mx, sx), (mw, sw), _ = quantize_operands(x, w, 8)
    if kernel == "lut_matmul":
        lut = artifacts.product_lut_u16(8, 4, True, x.device)
        args = (lut, mx.to(torch.uint8), sx, mw.to(torch.uint8), sw)
        got, want = lm.lut_matmul(*args, n=8), lm.lut_matmul_plain(*args, n=8)
    elif kernel == "seqmul_matmul":
        args = (mx.to(torch.int16), sx, mw.to(torch.int16), sw)
        got, want = sm.seqmul_matmul(*args, n=8, t=4), sm.seqmul_matmul_plain(*args, n=8, t=4)
    else:
        pa = pm.pack_i16_pairs(mx * sx.to(torch.int32), dim=1)
        pb = pm.pack_i16_pairs(mw * sw.to(torch.int32), dim=0)
        got, want = pm.packed_matmul(pa, pb, n=8), pm.packed_matmul_plain(pa, pb)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(4, 1024, 3072), (33, 300, 70), (128, 3072, 1024)])
def test_lowrank_matmul_matches_plain_version(m, k, n, card):
    from repro_torch.engine import artifacts
    from repro_torch.engine.modes import quantize_operands
    from repro_torch.kernels import lowrank_matmul as lr

    x, w = (torch.from_numpy(a).to(card) for a in _operands(m, k, n, seed=m + k))
    (mx, sx), (mw, sw), _ = quantize_operands(x, w, 8)
    u, v, _ = artifacts.svd_factors(8, 4, 8, True, card)
    args = (u, v, mx.to(torch.uint8), sx, mw.to(torch.uint8), sw)
    got, want = lr.lowrank_matmul(*args, n=8), lr.lowrank_matmul_plain(*args, n=8)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-6 * want.abs().max().item()


def _attn_inputs(card, b, s, t, h, kv, hd, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g, device=card).to(dtype)
    k = torch.randn((b, t, kv, hd), generator=g, device=card).to(dtype)
    v = torch.randn((b, t, kv, hd), generator=g, device=card).to(dtype)
    k_pos = torch.arange(t, device=card).expand(b, t).clone()
    k_pos[0, t - t // 4:] = -1  # an unwritten tail in row 0
    q_pos = torch.arange(s, device=card).expand(b, s) + (t - s)
    q_pos = torch.minimum(q_pos, k_pos.amax(dim=1, keepdim=True))
    return q, k, v, q_pos, k_pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,window,softcap", [(128, None, None), (64, 24, None),
                                               (16, None, 30.0)])
def test_flash_attention_matches_plain_version(hd, window, softcap, dtype, card):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, qp, kp = _attn_inputs(card, 2, 40, 72, 8, 2, hd, dtype, seed=hd)
    kw = dict(causal=True, window=window, softcap=softcap, scale=hd**-0.5)
    got = fa.flash_attention(q, k, v, qp, kp, **kw)
    want = fa.flash_attention_plain(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,kv,window,softcap", [(16, 8, None, None), (8, 1, 20, None),
                                                 (4, 4, None, 30.0)])
def test_flash_decode_matches_plain_version(h, kv, window, softcap, dtype, card):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _, kp = _attn_inputs(card, 3, 1, 100, h, kv, 128, dtype, seed=h + kv)
    qp = kp.amax(dim=1)
    kw = dict(window=window, softcap=softcap, scale=128**-0.5)
    got = fa.flash_decode(q[:, 0], k, v, qp, kp, **kw)
    want = fa.flash_decode_plain(q[:, 0], k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode,bk,window,softcap", [("bitexact", 16, None, None),
                                                     ("bitexact", 64, 24, 30.0),
                                                     ("lowrank", 16, 24, None),
                                                     ("lowrank", 128, None, 30.0)])
def test_approx_attention_matches_plain_version(mode, bk, window, softcap, card):
    from repro_torch.kernels import approx_attention as aa

    q, k, v, qp, kp = _attn_inputs(card, 2, 40, 128, 16, 8, 128, torch.bfloat16, seed=bk)
    kw = dict(mode=mode, n=8, t=4, rank=8, causal=True, window=window, softcap=softcap,
              scale=128**-0.5, bk=bk)
    got = aa.approx_flash_attention(q, k, v, qp, kp, **kw)
    want = aa.approx_attention_plain(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert err.max().item() <= v.float().abs().max().item() / 255
    assert (err <= 1e-5).float().mean().item() >= 0.99


def _bwd_inputs(card, b, s, h, kv, hd, dtype, seed, pad=0):
    """q/k/v over s causal positions, row 1 left-padded by ``pad`` (its pad
    queries have no allowed slot), and a float32 output cotangent."""
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g, device=card).to(dtype)
    k = torch.randn((b, s, kv, hd), generator=g, device=card).to(dtype)
    v = torch.randn((b, s, kv, hd), generator=g, device=card).to(dtype)
    do = torch.randn((b, s, h, hd), generator=g, device=card)
    shift = torch.zeros((b, 1), dtype=torch.int64, device=card)
    shift[1] = pad
    jj = torch.arange(s, device=card).expand(b, s)
    q_pos = (jj - shift).to(torch.int32)
    k_pos = torch.where(jj >= shift, jj - shift, -1).to(torch.int32)
    return q, k, v, q_pos, k_pos, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,kv,hd,window,softcap,pad", [(16, 8, 128, None, None, 0),
                                                        (8, 2, 64, 24, 30.0, 0),
                                                        (4, 4, 16, None, None, 5)])
def test_flash_backward_kernels_match_plain_version(h, kv, hd, window, softcap, pad, dtype,
                                                    card):
    """dq and dk/dv against ``flash_attention_bwd_plain`` on the forward
    kernel's (o, lse), float32 before the cast: within 1e-4 * max|want| per
    output (float32 sums in another order), the fully masked pad rows too."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, qp, kp, do = _bwd_inputs(card, 2, 72, h, kv, hd, dtype, seed=h + hd, pad=pad)
    kw = dict(causal=True, window=window, softcap=softcap, scale=hd**-0.5)
    o, lse = fa.flash_attention_fwd(q, k, v, qp, kp, **kw, with_lse=True)
    _, want_lse = fa.attend(q, k, v, qp, kp, **kw, with_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
    dd = torch.einsum("bshd,bshd->bhs", do, o)
    got = (fa.flash_attention_bwd_dq(q, k, v, qp, kp, do, lse, dd, **kw),
           *fa.flash_attention_bwd_dkv(q, k, v, qp, kp, do, lse, dd, **kw))
    want = fa.flash_attention_bwd_plain(q, k, v, qp, kp, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        err = (a - b_).abs().max().item()
        assert err <= 1e-4 * b_.abs().max().item(), (name, err)
    if pad:
        assert bool((got[0][1, :pad] == 0).all())


@pytest.mark.parametrize("mode", ["bitexact", "lowrank"])
def test_approx_attention_backward_runs_on_its_residuals(mode, card):
    """Straight-through: autograd of approx_flash_attention on the card is
    the dq and dk/dv kernels on the approximate kernel's (o, lse)."""
    from repro_torch.kernels import approx_attention as aa
    from repro_torch.kernels import flash_attention as fa

    q, k, v, qp, kp, do = _bwd_inputs(card, 2, 64, 16, 8, 128, torch.bfloat16, seed=9, pad=3)
    kw = dict(causal=True, window=None, softcap=None, scale=128**-0.5)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = (fa.DQ_KERNEL.launches, fa.DKV_KERNEL.launches)
    out = aa.approx_flash_attention(*leaves, qp, kp, mode, 8, 4, True, 8, bk=64, **kw)
    out.backward(do)
    assert (fa.DQ_KERNEL.launches, fa.DKV_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    ops = aa.kernel_operands(q, k, v, mode=mode, n=8, t=4, fix_to_1=True, rank=8)
    o, lse = aa.launch_kernel(ops, qp, kp, bk=64, with_lse=True, **kw)
    assert torch.equal(o, out.detach())
    want = fa.flash_attention_bwd_plain(q, k, v, qp, kp, o, lse, do, **kw)
    torch.cuda.synchronize()
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16 and bool(torch.isfinite(leaf.grad).all())
        err = (leaf.grad.float() - w).abs().max().item()
        # the kernels' float32 result, then one bf16 rounding
        assert err <= 1e-4 * w.abs().max().item() + w.abs().max().item() * 2.0**-8


def test_full_width_train_step_is_finite(card):
    """One step of full-width paper-multiplier with the pallas attention:
    lut_matmul forward, the flash forward with lse, dq and dk/dv."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config("paper-multiplier"), attn_impl="pallas")
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=4, warmup_steps=1)
    state = init_train_state(model, tcfg, 0, device=card)
    toks = torch.randint(0, cfg.vocab_size, (2, 129), device=card,
                         generator=torch.Generator(device=card).manual_seed(0))
    kernels.reset_launch_counts()
    state, metrics = make_train_step(model, tcfg)(
        state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0
    for name in ("lut_matmul", "flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert counts[name] > 0, counts
    assert all(bool(torch.isfinite(m).all()) for m in state.opt.mu)
    assert isinstance(state.opt, adamw.OptState)


def _u32_operands(shape, n, seed, card):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(0, 1 << n, shape, dtype=np.uint64)
                                  .astype(np.uint32)).to(card) for _ in range(2))


def _same_bits(got, want) -> bool:
    return got.dtype == want.dtype == torch.uint32 and bool(torch.equal(got, want))


@pytest.mark.parametrize("shape", [(), (0,), (1,), (127,), (129,), ((1 << 20) + 3,),
                                   (4096, 4096)], ids=str)
def test_seqmul_kernels_bitmatch_plain_versions(shape, card):
    """Both elementwise kernels at the smoke's sizes: ragged, 0-d, empty and
    2^24 elements, packed at n = 12 and words at the paper's n = 16."""
    from repro_torch.kernels import seqmul_kernel as sk

    a, b = _u32_operands(shape, 12, 1, card)
    got = sk.seqmul_packed(a, b, n=12, t=6)
    want = sk.seqmul_packed_plain(a, b, n=12, t=6)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    a, b = _u32_operands(shape, 16, 2, card)
    got = sk.seqmul_words(a, b, n=16, t=8)
    want = sk.seqmul_words_plain(a, b, n=16, t=8)
    torch.cuda.synchronize()
    assert all(_same_bits(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n", [1, 4, 8, 12, 15, 16])
def test_seqmul_kernels_bitmatch_plain_versions_over_splits(n, card):
    """Every kernel variant (exact, approximate with and without fix_to_1)
    at three splits, on int64 operands and on an unaligned uint32 view."""
    from repro_torch.kernels import seqmul_kernel as sk

    a, b = _u32_operands((1 << 16) + 5, n, n, card)
    wide = (a.long(), b.long())
    for t in sorted({1, max(1, n // 2), max(1, n - 1)}):
        for approx, fix in ((True, True), (True, False), (False, False)):
            kw = dict(n=n, t=t, approx=approx, fix_to_1=fix)
            for x, y in ((a, b), (a[1:], b[1:]), wide):
                low, high = sk.seqmul_words(x, y, **kw)
                want_low, want_high = sk.seqmul_words_plain(x, y, **kw)
                assert _same_bits(low, want_low) and _same_bits(high, want_high), kw
                if 2 * n <= 31:
                    assert _same_bits(sk.seqmul_packed(x, y, **kw),
                                      sk.seqmul_packed_plain(x, y, **kw)), kw


def test_seqmul_launch_counts_and_engine_multiply(card):
    """One launch per call that has elements, none for an empty one or a CPU
    tensor; ``engine.multiply`` (auto) and ``ops.approx_multiply`` run the
    packed kernel and agree with the reference body."""
    from repro_torch import engine, kernels
    from repro_torch.kernels import ops
    from repro_torch.kernels import seqmul_kernel as sk

    a, b = _u32_operands((8, 128), 8, 3, card)
    kernels.reset_launch_counts()
    got = engine.multiply(a, b, n=8, t=4)
    shim = ops.approx_multiply(a, b)
    sk.seqmul_words(a, b, n=8, t=4)
    sk.seqmul_packed(a[:0], b[:0], n=8, t=4)
    sk.seqmul_words(a.cpu(), b.cpu(), n=8, t=4)
    counts = kernels.launch_counts()
    assert counts["seqmul_packed"] == 2 and counts["seqmul_words"] == 1, counts
    want = engine.multiply(a, b, n=8, t=4, backend="reference")
    assert _same_bits(got, want) and _same_bits(shim, want)
    assert _same_bits(want.cpu(), engine.multiply(a.cpu(), b.cpu(), n=8, t=4))


def test_engine_multiply_with_one_operand_on_the_card(card):
    """An array-like beside a CUDA tensor joins it on the card and launches
    the packed kernel; a CPU tensor beside a CUDA tensor raises."""
    from repro_torch import engine, kernels

    a, b = _u32_operands((1000,), 8, 4, card)
    want = engine.multiply(a, b, n=8, t=4, backend="reference")
    for x, y in ((a.cpu().numpy(), b), (a, b.cpu().numpy())):
        kernels.reset_launch_counts()
        got = engine.multiply(x, y, n=8, t=4)
        assert kernels.launch_counts()["seqmul_packed"] == 1
        assert got.device == a.device and _same_bits(got, want)
    for x, y in ((a.cpu(), b), (a, b.cpu())):
        with pytest.raises(ValueError, match="cpu"):
            engine.multiply(x, y, n=8, t=4)


def test_error_analysis_on_the_card_equals_the_cpu(card):
    """``exhaustive_eval`` and ``mc_eval`` on the card report what the CPU
    reports, field for field; up to n = 16 the card's products come from
    the ``seqmul_words`` kernel."""
    from repro_torch import kernels
    from repro_torch.core import error_metrics

    for kw in (dict(n=1, t=1), dict(n=8, t=4), dict(n=8, t=3, fix_to_1=False)):
        kernels.reset_launch_counts()
        assert (error_metrics.exhaustive_eval(**kw, device=card)
                == error_metrics.exhaustive_eval(**kw, device="cpu"))
        assert kernels.launch_counts()["seqmul_words"] == 1  # one chunk
    for n, t in ((16, 8), (32, 16)):
        kw = dict(samples=1 << 16, seed=n)
        assert (error_metrics.mc_eval(n, t, device=card, **kw)
                == error_metrics.mc_eval(n, t, device="cpu", **kw))
