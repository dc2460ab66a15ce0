"""The port's simulated error analysis (``repro_torch.core.error_metrics``)
against the JAX package: every ``ErrorReport`` field equal, floats
included (the same numpy operations on the same integers), for exhaustive
and Monte-Carlo runs; ``lut_stats`` and ``dequantize`` beside them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import error_metrics as jax_error_metrics
from repro.core import luts as jax_luts
from repro.core import quantization as jax_quant
from repro_torch.core import error_metrics, luts, quantization

CPU = "cpu"


def _assert_same_report(got, want):
    assert type(got).__name__ == "ErrorReport"
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys()
    for key in w:
        assert type(g[key]) is type(w[key]), key
        assert g[key] == w[key], f"{key}: {g[key]!r} != {w[key]!r}"
    assert got.summary() == want.summary()


@pytest.mark.parametrize("n,t,fix", [(1, 1, True), (4, 1, True), (4, 2, False), (4, 3, True),
                                     (6, 3, True), (6, 5, False), (8, 4, False), (8, 4, True),
                                     (8, 7, True)])
def test_exhaustive_eval_equals_the_reference(n, t, fix):
    _assert_same_report(error_metrics.exhaustive_eval(n, t, fix_to_1=fix, device=CPU),
                        jax_error_metrics.exhaustive_eval(n, t, fix_to_1=fix))


def test_exhaustive_eval_in_chunks_smaller_than_the_space():
    got = error_metrics.exhaustive_eval(6, 2, chunk=1000, device=CPU)
    _assert_same_report(got, jax_error_metrics.exhaustive_eval(6, 2, chunk=1000))
    _assert_same_report(got, error_metrics.exhaustive_eval(6, 2, device=CPU))


@pytest.mark.parametrize("n,t", [(12, 6), (16, 8), (32, 16)])
def test_mc_eval_equals_the_reference(n, t):
    for fix in (True, False):
        kw = dict(samples=1 << 14, fix_to_1=fix, seed=n, chunk=5000)
        _assert_same_report(error_metrics.mc_eval(n, t, device=CPU, **kw),
                            jax_error_metrics.mc_eval(n, t, **kw))


def test_mc_eval_with_measured_input_pdfs_equals_the_reference():
    n, t = 8, 3
    pdf = np.exp(-0.5 * (np.arange(1 << n) / 40.0) ** 2)
    pdf /= pdf.sum()
    flat = np.full(1 << n, 1.0 / (1 << n))
    for pa, pb in ((pdf, None), (None, pdf), (pdf, flat)):
        kw = dict(samples=1 << 13, seed=2, pdf_a=pa, pdf_b=pb)
        _assert_same_report(error_metrics.mc_eval(n, t, device=CPU, **kw),
                            jax_error_metrics.mc_eval(n, t, **kw))


def test_eval_pairs_equals_the_reference():
    rng = np.random.default_rng(9)
    for n, t in ((8, 4), (16, 9), (32, 5)):
        a = rng.integers(0, 1 << n, 3000, dtype=np.uint64)
        b = rng.integers(0, 1 << n, 3000, dtype=np.uint64)
        for exhaustive in (False, True):
            _assert_same_report(
                error_metrics.eval_pairs(a, b, n=n, t=t, exhaustive=exhaustive, device=CPU),
                jax_error_metrics.eval_pairs(a, b, n=n, t=t, exhaustive=exhaustive))


def test_error_analysis_needs_a_device_or_the_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        error_metrics.exhaustive_eval(4, 2)
    with pytest.raises(ValueError, match="infeasible"):
        error_metrics.exhaustive_eval(15, 7, device=CPU)


@pytest.mark.parametrize("n,t", [(2, 1), (4, 2), (6, 3), (8, 4), (8, 7)])
def test_lut_stats_equal_the_reference(n, t):
    for fix in (True, False):
        assert luts.lut_stats(n, t, fix_to_1=fix) == jax_luts.lut_stats(n, t, fix_to_1=fix)


def test_dequantize_bitmatches_the_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 33)).astype(np.float32)
    for bits, axis in ((8, None), (4, 0), (12, 1)):
        jqp = jax_quant.calibrate_absmax(jnp.asarray(x), bits=bits, axis=axis)
        jmag, jsign = jax_quant.quantize(jnp.asarray(x), jqp)
        want = np.asarray(jax_quant.dequantize(jmag, jsign, jqp))
        qp = quantization.calibrate_absmax(torch.from_numpy(x), bits=bits, dim=axis)
        mag, sign = quantization.quantize(torch.from_numpy(x), qp)
        got = quantization.dequantize(mag, sign, qp)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
