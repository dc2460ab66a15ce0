"""The port's workload traces against the JAX package's.

``repro_torch.serve.workload`` is a copy of ``repro.serve.workload`` (numpy
only): for the same spec and seed both must draw the same trace, byte for
byte, which the SHA-256 ``trace_digest`` pins down, and every request the
two generators yield must be equal field by field.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serve import request as jax_request
from repro.serve import workload as jax_wl
from repro_torch.serve import request as torch_request
from repro_torch.serve import workload as torch_wl

SIZES = dict(requests=40, prompt_len=16, max_new=8, vocab_size=512)
SEEDS = (0, 1, 7)


def _same_request(a, b) -> None:
    assert (a.id, a.max_new, a.eos_id, a.quality, a.slo_ttft_s, a.strategy) == (
        b.id, b.max_new, b.eos_id, b.quality, b.slo_ttft_s, b.strategy)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.tokens.dtype == b.tokens.dtype


def test_registries_are_the_same():
    assert torch_wl.ARRIVALS == jax_wl.ARRIVALS
    assert torch_wl.LENGTH_DISTS == jax_wl.LENGTH_DISTS
    assert torch_wl.PRESETS == jax_wl.PRESETS


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("preset", sorted(jax_wl.PRESETS))
def test_trace_digest_equals_the_reference(preset, seed):
    kw = dict(SIZES, tier_mix=(("balanced", 3.0), (None, 1.0)), slo_ttft_s=0.05)
    want = jax_wl.trace_digest(jax_wl.preset_spec(preset, **kw), seed)
    got = torch_wl.trace_digest(torch_wl.preset_spec(preset, **kw), seed)
    assert got == want


@pytest.mark.parametrize("preset", sorted(jax_wl.PRESETS))
def test_generate_and_windows_draw_the_same_requests(preset):
    kw = dict(SIZES, eos_id=3)
    want = jax_wl.generate(jax_wl.preset_spec(preset, **kw), seed=5)
    got = torch_wl.generate(torch_wl.preset_spec(preset, **kw), seed=5)
    assert got.arrivals_s == want.arrivals_s
    assert got.offered_rps == want.offered_rps
    for a, b in zip(got.requests, want.requests, strict=True):
        _same_request(a, b)
    windows = list(torch_wl.iter_windows(torch_wl.preset_spec(preset, **kw), 5, 16))
    ref_windows = list(jax_wl.iter_windows(jax_wl.preset_spec(preset, **kw), 5, 16))
    assert [len(r) for r, _ in windows] == [len(r) for r, _ in ref_windows] == [16, 16, 8]
    for (reqs, times), (ref_reqs, ref_times) in zip(windows, ref_windows):
        assert times == ref_times
        for a, b in zip(reqs, ref_reqs, strict=True):
            _same_request(a, b)


@pytest.mark.parametrize("workload", [None, "steady", "bursty", "flood", "churn"])
def test_synth_requests_with_a_workload_draws_the_same_queue(workload):
    kw = dict(prompt_len=12, gen=6, vocab_size=300, seed=2, eos_id=9, workload=workload,
              tier_mix=(("high", 1.0), ("draft", 2.0)) if workload == "bursty" else ())
    if workload == "steady":
        kw["quality"] = "balanced"  # tags everything when no tier_mix is given
    want = jax_request.synth_requests(11, **kw)
    got = torch_request.synth_requests(11, **kw)
    for a, b in zip(got, want, strict=True):
        _same_request(a, b)
    if workload == "steady":
        assert {r.quality for r in got} == {"balanced"}


def test_tier_mix_label_and_spec_validation():
    mix = (("balanced", 3.0), (None, 1.0))
    assert torch_wl.tier_mix_label(mix) == jax_wl.tier_mix_label(mix) == "balanced:3+none:1"
    assert torch_wl.tier_mix_label(()) == "none"
    for bad in (dict(arrival="sometimes"), dict(rate_rps=0.0), dict(zipf_a=1.0),
                dict(spec_fraction=1.5), dict(min_gen=9)):
        with pytest.raises(ValueError):
            torch_wl.WorkloadSpec(**SIZES, **bad)
    with pytest.raises(ValueError, match="unknown workload preset"):
        torch_wl.preset_spec("storm", **SIZES)
