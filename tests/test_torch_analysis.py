"""The port's static kernel certifier (``repro_torch.analysis``) on the CPU.

The reference's auditor cannot run under jax 0.9.0 (its interpreter calls
``jax.core.Literal``, which that version removed), so the port is held
here against what does run and what the reference pins:

- the port's ``Interval`` transfer functions against
  ``repro.analysis.domain`` (which imports only jax.numpy) on random
  intervals (hypothesis);
- the frontier facts of ``docs/analysis.md`` and ``tests/test_analysis.py``:
  seqmul n = 12 certifies and n = 13 is refused, the packed single word
  certifies at n = 15 and breaks its contract at n = 16, two words carry
  n = 16;
- mutations that must stop certifying: a widened carry weight, a dropped
  gather clamp, an oversized tile, a tile that is not a power of two; an
  aten op without a transfer function;
- each kernel's carrier-faithful body bit-equal to its plain version on
  random and all-max inputs, so the audit is of the same function;
- ``resolve_t`` never returns an uncertified split, the armed gate
  refuses, and ``python -m repro_torch.launch.analyze --report`` writes a
  machine-readable report (the matrix runs once per module).
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.analysis.domain as ref_domain
from repro.engine import config as jax_engine_config
from repro_torch.analysis import audit, contracts, domain, smem
from repro_torch.analysis.interp import GATING_KINDS, interpret
from repro_torch.analysis.spec import TraceSpec, sds
from repro_torch.engine import config as engine_config
from repro_torch.kernels import (
    build, lowrank_matmul, lut_matmul, packed_matmul, seqmul_kernel, seqmul_matmul,
)


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    """The analyze CLI once for the module: its exit code and its report."""
    from repro_torch.launch import analyze

    path = tmp_path_factory.mktemp("audit") / "audit.json"
    rc = analyze.main(["--report", str(path)])
    return rc, json.loads(path.read_text())


# ------------------------------------------------------- the interval domain
_BOUND = 1 << 20


@st.composite
def intervals(draw, lo=-_BOUND, hi=_BOUND, integers=False):
    elems = st.integers(lo, hi) if integers else st.floats(lo, hi, allow_nan=False)
    a, b = sorted((draw(elems), draw(elems)))
    iv = draw(st.booleans()) or integers
    return float(a), float(b), iv


def _pair(t):
    lo, hi, iv = t
    return domain.Interval(lo, hi, int_valued=iv), ref_domain.Interval(lo, hi, int_valued=iv)


def _same(a, b):
    assert (a.lo, a.hi, a.int_valued, a.reduced) == (b.lo, b.hi, b.int_valued, b.reduced)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "min_", "max_", "div"])
@settings(max_examples=150, deadline=None)
@given(x=intervals(), y=intervals())
def test_arithmetic_transfer_matches_reference(op, x, y):
    (a, ra), (b, rb) = _pair(x), _pair(y)
    _same(getattr(domain, op)(a, b), getattr(ref_domain, op)(ra, rb))


@pytest.mark.parametrize("op", ["bit_and", "bit_or", "bit_xor"])
@settings(max_examples=150, deadline=None)
@given(x=intervals(-64, 1 << 16, integers=True), y=intervals(-64, 1 << 16, integers=True))
def test_bitwise_transfer_matches_reference(op, x, y):
    (a, ra), (b, rb) = _pair(x), _pair(y)
    if op == "bit_and":
        _same(domain.bit_and(a, b), ref_domain.bit_and(ra, rb))
    else:
        xor = op == "bit_xor"
        _same(domain.bit_or(a, b, is_xor=xor), ref_domain.bit_or(ra, rb, is_xor=xor))


@pytest.mark.parametrize("op", ["shift_left", "shift_right"])
@settings(max_examples=150, deadline=None)
@given(x=intervals(-(1 << 16), 1 << 16, integers=True), s=intervals(0, 12, integers=True))
def test_shift_transfer_matches_reference(op, x, s):
    (a, ra), (b, rb) = _pair(x), _pair(s)
    _same(getattr(domain, op)(a, b), getattr(ref_domain, op)(ra, rb))


@pytest.mark.parametrize("fn", [math.exp, math.tanh, lambda v: 1 / (1 + math.exp(-v))])
@settings(max_examples=100, deadline=None)
@given(x=intervals(-30, 30))
def test_monotone_transfer_matches_reference(fn, x):
    (a, ra), _ = _pair(x), None
    _same(domain.monotone_unary(a, fn), ref_domain.monotone_unary(ra, fn))


def test_bit_or_envelope_is_tight_for_disjoint_fields():
    """The recurrence's augend joins disjoint fields: [0, 2^(t-1) - 1] |
    [0, 2^(t-1)] is at most 2^t - 1, not their sum's doubling."""
    out = domain.bit_or(domain.Interval(0, 7, True), domain.Interval(0, 8, True))
    assert out.hi == 15


# -------------------------------------------------------- frontier facts
@pytest.mark.parametrize("mode,n,t,want", [
    ("seqmul", 12, 6, True), ("seqmul", 13, 6, False), ("bitexact", 8, 4, True),
    ("inject", 8, 4, True), ("lowrank", 8, 4, True),
])
def test_gemm_routes_certify_within_the_dispatch_contract(mode, n, t, want):
    assert audit.certified(mode, n, t) is want


def test_seqmul_certificate_records_both_bounds():
    """The port sums exact integers and its int16 magnitudes hold n <= 15;
    the reference's float32 assembly binds at n <= 12.  The certificate
    records both and certifies within both."""
    res = audit._audit_gemm("seqmul", 13, 6)
    assert not res.certified
    assert res.facts["dispatch_contract_n"] == 12 and res.facts["derived_frontier_n"] == 15
    assert [f.kind for f in res.findings if f.gating] == ["dispatch-contract"]


@pytest.mark.parametrize("kind,n,t,want", [
    ("packed_single", 15, 7, True), ("packed_single", 16, 8, False),
    ("packed_words", 16, 8, True), ("seqmul_gemm", 15, 7, True), ("seqmul_gemm", 16, 8, False),
    ("packed_gemm", 15, 7, True), ("packed_gemm", 16, 8, False), ("lut_gemm", 8, 4, True),
    ("lut_gemm", 9, 4, False), ("lowrank_gemm", 8, 4, True),
])
def test_kernel_contracts_rediscover_the_bounds(kind, n, t, want):
    res = audit.audit_kernel(contracts.kernel_trace(kind, n, t))
    assert res.certified is want, [f.message for f in res.findings if f.gating]
    if kind == "packed_single" and not want:
        assert [f.kind for f in res.findings if f.gating] == ["contract"]


@pytest.mark.parametrize("kind,widths", [
    ("lut_gemm", range(1, 9)), ("packed_gemm", range(1, 16)), ("lowrank_gemm", range(1, 9)),
    ("seqmul_gemm", (1, 2, 3)),
])
def test_every_width_a_wrapper_takes_certifies(kind, widths):
    """Each GEMM kernel at every bit width its wrapper accepts, at its int32
    edge of K (not a whole number of stages at small n: the sums there must
    count the K products, not K rounded up to whole stages)."""
    for n in widths:
        res = audit.audit_kernel(contracts.kernel_trace(kind, n, max(1, n // 2)))
        assert res.certified, (n, [f.message for f in res.findings if f.gating])


def test_int32_accumulators_hold_exactly_to_the_wide_accumulator_edge():
    """``build.wide_accumulator`` keeps a sum in int32 while K times the
    product bound stays below 2^31: at the edge the int32 carrier holds,
    one stage past it (forced int32) it overflows."""
    edge = lut_matmul.int32_k_limit(8)
    assert not build.wide_accumulator(edge, (1 << 16) - 1)
    assert audit.audit_kernel(lut_matmul.audit_trace(n=8, k=edge)).certified
    past = lut_matmul.audit_trace(n=8, k=edge + 32, wide=False)
    kinds = {f.kind for f in audit.audit_kernel(past).findings if f.gating}
    assert "overflow" in kinds
    assert audit.audit_kernel(lut_matmul.audit_trace(n=8, k=edge + 32)).certified  # int64
    chunk = lowrank_matmul.max_k_chunk(8)
    bad = lowrank_matmul.audit_trace(n=8, k_chunk=chunk + 32)
    assert not audit.audit_kernel(bad).certified


# ------------------------------------------------------------- mutations
def test_widened_carry_weight_is_caught():
    res = audit.audit_kernel(seqmul_matmul.audit_trace(n=8, t=4, carry_weight=2))
    assert not res.certified
    assert any("s_msp" in f.message for f in res.findings if f.kind == "overflow")


def test_dropped_gather_clamp_is_caught():
    """At n = 4 a uint8 magnitude can pass 2^n - 1: the kernel's clamp is
    what keeps the lookup inside the 256-entry table."""
    assert audit.audit_kernel(lut_matmul.audit_trace(n=4)).certified
    res = audit.audit_kernel(lut_matmul.audit_trace(n=4, clamp=False))
    assert [f.kind for f in res.findings if f.gating] == ["gather"]


@pytest.mark.parametrize("mode,tile,match", [
    ("bitexact", (32, 1024), "not one the kernel is built for"),
    ("seqmul", (3, 128), "power of two"),
    ("lowrank", (64, 48), "power of two"),
])
def test_bad_tiles_are_refused(mode, tile, match):
    with pytest.raises(smem.TileBudgetError, match=match) as e:
        smem.validate_tiles(mode, 8, 4, tile)
    assert f"n=8, t=4" in str(e.value)


def test_oversized_block_is_refused():
    with pytest.raises(smem.TileBudgetError, match="shared memory"):
        smem.validate_tiles("bitexact", 9, 4, (4, 512))  # a 512 KiB table
    with pytest.raises(smem.TileBudgetError, match="rank=41"):
        engine_config.kernel_tiles("lowrank", 8, 4, 128, rank=41)
    with pytest.raises(smem.TileBudgetError, match="292240 bytes of shared memory"):
        smem.validate_attention("lowrank", 8, 256, 24)


@pytest.mark.parametrize("mode", ["bitexact", "seqmul", "inject", "lowrank"])
def test_every_deployed_tile_fits(mode):
    mod = smem._gemm_module(mode)
    for n in ((8, 12) if mode == "seqmul" else (8,)):
        for tile in mod.TILES:
            fp = smem.validate_tiles(mode, n, 4, tile)
            assert fp.within and fp.blocks_per_sm >= 1


def test_unmodelled_op_gates():
    spec = TraceSpec(name="lgamma", fn=lambda x: torch.lgamma(x) + 1,
                     args=[sds((4,), torch.float32)])
    rep, _ = interpret(spec)
    assert "unmodelled-op" in GATING_KINDS and not rep.certified
    assert [f.kind for f in rep.gating_findings] == ["unmodelled-op"]


# ------------------------------------------- the bodies are the functions
def _operands(shape_a, shape_b, n, dtype, seed, all_max):
    g = torch.Generator().manual_seed(seed)
    hi = 1 << n
    ma = torch.randint(0, hi, shape_a, generator=g)
    mb = torch.randint(0, hi, shape_b, generator=g)
    if all_max:
        ma.fill_(hi - 1)
        mb.fill_(hi - 1)
    sa = torch.randint(-1, 2, shape_a, generator=g).to(torch.int8)
    sb = torch.randint(-1, 2, shape_b, generator=g).to(torch.int8)
    return ma.to(dtype), sa, mb.to(dtype), sb


@pytest.mark.parametrize("all_max", [False, True], ids=["random", "all-max"])
def test_carrier_bodies_equal_the_plain_versions(all_max):
    from repro_torch.engine import artifacts

    cpu = torch.device("cpu")
    for n, t in ((4, 2), (8, 4)):
        ma, sa, mb, sb = _operands((3, 70), (70, 5), n, torch.uint8, n, all_max)
        lut = artifacts.product_lut_u16(n, t, True, cpu)
        want = lut_matmul.lut_matmul_plain(lut, ma, sa, mb, sb, n=n)
        assert torch.equal(lut_matmul.audit_body(lut, ma, sa, mb, sb, n=n, wide=False), want)
        u, v, _ = artifacts.svd_factors(n, t, 8, True, cpu)
        want = lowrank_matmul.lowrank_matmul_plain(u, v, ma, sa, mb, sb, n=n)
        got = lowrank_matmul.audit_body(u, v, ma, sa, mb, sb, n=n, k_chunk=64)
        assert torch.equal(got, want)
    for n, t in ((1, 1), (5, 2), (12, 6)):
        ma, sa, mb, sb = _operands((3, 40), (40, 4), n, torch.int16, 10 + n, all_max)
        want = seqmul_matmul.seqmul_matmul_plain(ma, sa, mb, sb, n=n, t=t)
        assert torch.equal(seqmul_matmul.audit_body(ma, sa, mb, sb, n=n, t=t, wide=False), want)
    for n in (8, 15):
        qa, _, qb, _ = _operands((3, 41), (41, 6), n - 1, torch.int64, 20 + n, all_max)
        sign_a, sign_b = _operands((3, 41), (41, 6), 1, torch.int64, 30 + n, False)[1::2]
        qa, qb = qa * sign_a, qb * sign_b
        want = packed_matmul.packed_matmul_plain(packed_matmul.pack_i16_pairs(qa, dim=1),
                                                 packed_matmul.pack_i16_pairs(qb, dim=0))
        got = packed_matmul.audit_body(packed_matmul.audit_pack(qa, dim=1),
                                       packed_matmul.audit_pack(qb, dim=0), n=n, wide=False)
        assert torch.equal(got, want)
    for n, t in ((8, 4), (15, 7), (16, 8)):
        a, _, b, _ = _operands((300,), (300,), n, torch.int64, 40 + n, all_max)
        lo, hi = seqmul_kernel.seqmul_words_plain(a, b, n=n, t=t)
        got_lo, got_hi = seqmul_kernel.audit_body_words(a, b, n=n, t=t)
        assert torch.equal(got_lo, lo.to(torch.int64)) and torch.equal(got_hi, hi.to(torch.int64))
        if 2 * n <= 31:
            want = seqmul_kernel.seqmul_packed_plain(a, b, n=n, t=t).to(torch.int64)
            assert torch.equal(seqmul_kernel.audit_body_packed(a, b, n=n, t=t), want)


# ------------------------------------------------- the controller and gate
def test_tiers_resolve_to_the_reference_pins_at_n8():
    """high: mlp/moe t = 2, attn t = 1; balanced: 4 and 2; draft: 4."""
    pins = {"high": {"mlp": 2, "moe": 2, "attn": 1}, "balanced": {"mlp": 4, "moe": 4, "attn": 2},
            "draft": {"mlp": 4, "moe": 4}}
    for tier, want in pins.items():
        got = engine_config.resolve_tier(tier, n=8)
        assert {q.target: q.t for q in got.per_target} == want
        for q in got.per_target:
            assert audit.certified(q.mode, q.n, q.t)
    assert jax_engine_config.get_tier("balanced").budgets[0][0] == "mlp"


def test_resolve_t_cannot_return_uncertified(monkeypatch):
    budget = engine_config.get_tier("balanced").budgets[0][1]
    p = engine_config.resolve_t(8, budget, mode="seqmul")
    assert audit.certified("seqmul", 8, p.t)
    # refuse the delay-optimal split: the controller takes the next certified one
    monkeypatch.setattr(audit, "certified", lambda mode, n, t: t != p.t)
    q = engine_config.resolve_t(8, budget, mode="seqmul")
    assert q.t != p.t and q.delay >= p.delay
    monkeypatch.setattr(audit, "certified", lambda *a, **k: False)
    with pytest.raises(engine_config.QualityError, match="certification"):
        engine_config.resolve_t(8, budget, mode="seqmul")


def test_armed_gate_refuses_before_the_launch(monkeypatch):
    audit.GATE_CHECKS.clear()
    build.audit_gate("seqmul_matmul", "seqmul", 13, 6)  # unarmed: nothing
    assert not audit.GATE_CHECKS
    monkeypatch.setenv("REPRO_STATIC_AUDIT", "1")
    with pytest.raises(audit.CertificationError, match="seqmul"):
        build.audit_gate("seqmul_matmul", "seqmul", 13, 6)
    with pytest.raises(audit.CertificationError, match="packed_single"):
        build.audit_gate("seqmul_packed", "packed_single", 16, 8)
    with pytest.raises(audit.CertificationError, match="attention:lowrank"):
        build.audit_gate("approx_attention_lowrank", "attention:lowrank", 8, 4, hd=256, rank=24)
    build.audit_gate("lut_matmul", "lut_gemm", 8, 4)
    build.audit_gate("flash_attention", "flash", hd=128, dtype=torch.bfloat16)
    build.audit_gate("seqmul_words", "packed_words", 16, 8)
    assert dict(audit.GATE_CHECKS) == {"lut_matmul": 1, "flash_attention": 1, "seqmul_words": 1}
    monkeypatch.setattr(audit, "certified", lambda *a, **k: False)
    with pytest.raises(audit.CertificationError):
        build.audit_gate("engine.matmul", "bitexact", 8, 4)
    audit.GATE_CHECKS.clear()


# ------------------------------------------------------------ the report
def test_report_is_machine_readable(report):
    rc, rep = report
    assert rc == 0 and rep["all_deployed_certified"] and rep["frontier_holds"]
    assert rep["smem_per_block_bytes"] == 232_448 and rep["regs_per_sm"] == 65_536
    names = {e["name"] for e in rep["entries"]}
    assert {"gemm:bitexact[n=8,t=4]", "gemm:inject[n=8,t=4]", "gemm:seqmul[n=12,t=6]",
            "attention:bitexact[n=8,t=2]", "kernel:seqmul_words[n=16,t=8]"} <= names
    for e in rep["entries"]:
        assert set(e) >= {"name", "family", "mode", "n", "t", "certified", "deployed",
                          "findings", "facts", "smem"}
        assert e["certified"] == (not any(f["gating"] for f in e["findings"]))


def test_report_refuses_only_lowrank_attention_at_256_among_blocks(report):
    """The one refusal of the shared-memory pass: lowrank attention at head
    width 256 and rank 24, 292,240 bytes over 232,448; every deployed
    entry certifies."""
    _, rep = report
    refused = [e for e in rep["entries"] if not e["certified"]]
    assert all(not e["deployed"] for e in refused)
    smem_refusals = [e for e in refused if e["family"] == "smem"]
    assert [e["name"] for e in smem_refusals] == [
        "smem:approx_attention_lowrank[n=8,hd=256,rank=24]"]
    assert "292240 bytes of shared memory, over 232448" in \
        smem_refusals[0]["findings"][0]["message"]
    gathers = [e["facts"] for e in rep["entries"] if e["family"] == "attention"]
    assert gathers and all(f["gathers_proven"] == f["gathers_checked"] > 0 for f in gathers)


def test_numbers_in_the_report_are_finite_json(report):
    _, rep = report
    text = json.dumps(rep)
    assert "NaN" not in text and "Infinity" not in text
    peaks = [np.float64(v["peak"]) for e in rep["entries"]
             for v in e["facts"].get("carriers", {}).values()]
    assert peaks and all(np.isfinite(peaks))
