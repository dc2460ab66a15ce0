"""The port's FLOP and byte counter (``repro_torch.launch.hlo_analysis``)
and the dry-run's per-device counts, on the CPU.

The FLOP count is held equal to the reference's ``analyze_hlo`` (which
runs here) on a matmul, an L-step loop and its gradient: the reference
weights its while body by the trip count, the port runs the Python loop
on meta tensors, so both count every product as often as it runs.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.configs.registry import get_config, shapes_for
from repro_torch.engine import modes
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as H


def _jax_flops(fn, *args) -> float:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


def _loop(x, w):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x.sum()


def _jax_loop(w, x):
    return jax.lax.scan(lambda c, wi: (jnp.tanh(c @ wi), None), x, w)[0].sum()


def test_matmul_flops_equal_the_reference():
    m, k, n = 64, 128, 32
    want = _jax_flops(lambda x, y: x @ y, jax.ShapeDtypeStruct((m, k), jnp.float32),
                      jax.ShapeDtypeStruct((k, n), jnp.float32))
    got = H.analyze(lambda x, y: x @ y, [_meta(m, k), _meta(k, n)])
    assert got.flops == want == 2 * m * k * n
    # the eager byte model: both operands read once, the result written once
    assert got.bytes == 4 * (m * k + k * n + m * n)


def test_loop_flops_equal_the_reference():
    L, d, b = 7, 32, 4
    want = _jax_flops(_jax_loop, jax.ShapeDtypeStruct((L, d, d), jnp.float32),
                      jax.ShapeDtypeStruct((b, d), jnp.float32))
    got = H.analyze(_loop, [_meta(b, d), _meta(L, d, d)])
    assert got.flops == want == L * 2 * b * d * d


def test_gradient_flops_equal_the_reference():
    """Forward one product, backward two, per step (the reference's
    backward scan computes every step's input gradient, so the port's
    takes the gradient in both operands)."""
    L, d, b = 5, 16, 2
    want = _jax_flops(jax.grad(_jax_loop, argnums=(0, 1)),
                      jax.ShapeDtypeStruct((L, d, d), jnp.float32),
                      jax.ShapeDtypeStruct((b, d), jnp.float32))

    def grad(x, w):
        return torch.autograd.grad(_loop(x, w), [x, w])

    got = H.analyze(grad, [_meta(b, d, grad=True), _meta(L, d, d, grad=True)])
    assert got.flops == pytest.approx(want, rel=1e-9)
    assert got.flops == 3 * L * 2 * b * d * d


@pytest.mark.parametrize("mode,rank", [("bitexact", 0), ("seqmul", 0), ("inject", 0),
                                       ("lowrank", 8)])
def test_a_kernel_call_counts_the_gemm_it_computes(mode, rank):
    """The engine's CUDA route on meta tensors: the kernel stands as one op
    with its operands, its (M, N) float32 result and 2 M K N (1 + r) FLOPs."""
    m, k, n = 4, 96, 40
    p = modes.GemmParams(n=8, t=4, fix_to_1=True, rank=8)
    spec = modes.get_mode(mode)
    args = [_meta(m, k), _meta(k, n)] + ([_meta(m, n)] if spec.prepare else [])
    got = H.analyze(lambda *a: spec.cuda(a[0], a[1], p, *a[2:]), args)
    kernel = [r for r in got.ops if r.name.endswith("_matmul")]
    assert len(kernel) == 1
    assert kernel[0].flops == got.flops == 2 * m * k * n * (1 + rank)
    assert kernel[0].bytes >= m * n * 4 + m * k + k * n
    assert "engine/modes.py" in kernel[0].module


def test_records_carry_the_module_path():
    from repro_torch.models.layers import rms_norm

    got = H.analyze(lambda x, w: rms_norm(x, w, 1e-6) @ w.new_empty((8, 3)),
                    [_meta(2, 8), _meta(8)])
    assert any("models/layers.py" in r.module and "rms_norm" in r.module for r in got.ops)
    assert max(got.ops, key=lambda r: r.flops).name == "mm"


def test_dryrun_prints_flops_and_bytes_for_every_cell(capsys):
    """Every cell of qwen3-0.6b on both production meshes: FLOPs and bytes
    per device, non-null; the collective bytes of its sharded step by kind
    (its layers are tensor-parallel), and their term."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-0.6b", "--mesh", "both"])
    assert e.value.code == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    cells = list(shapes_for(get_config("qwen3-0.6b")))
    assert [r["shape"] for r in recs] == [s for s in cells for _ in (0, 1)]
    for r in recs:
        assert r["ok"] and r["flops_per_dev"] > 0 and r["bytes_per_dev"] > 0
        coll = r["collective_bytes_per_dev"]
        assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
        assert r["terms_s"]["collective"] == pytest.approx(sum(coll.values()) / dryrun.HW.NVLINK_BW)
        assert r["layer_kinds"] == {"attn_global": 28}
    single = {r["shape"]: r for r in recs if r["mesh"] == "single"}
    multi = {r["shape"]: r for r in recs if r["mesh"] == "multi"}
    for shape in cells:  # twice the data ranks, half the batch and the products
        assert multi[shape]["batch_per_dev"] * 2 == single[shape]["batch_per_dev"]
        assert multi[shape]["flops_per_dev"] * 2 == pytest.approx(
            single[shape]["flops_per_dev"], rel=1e-9)
    # a decode step: 2 N FLOPs a row (N the parameters that multiply, the
    # head included, as model_flops counts them) and the attention's q k and
    # p v over every slot of the 32k cache, all of it split over the 16
    # model ranks (the layers are tensor-parallel: each rank runs its
    # blocks, and attends with every head over its sixteenth of the slots)
    cfg, shape = get_config("qwen3-0.6b"), dryrun.SHAPES["decode_32k"]
    b = single["decode_32k"]["batch_per_dev"]
    params = dryrun.model_flops(cfg, shape, "decode") / (2 * shape.global_batch)
    attention = 4 * b * cfg.num_heads * shape.seq_len * cfg.head_dim * cfg.num_layers
    want = (2 * params * b + attention) / 16
    assert single["decode_32k"]["flops_per_dev"] == pytest.approx(want, rel=0.02)


def test_moe_expert_gemms_split_over_the_model_axis():
    """granite-moe's expert GEMMs (and its attention) split over the model
    axis: its per-device FLOPs lie below the count of the same rows' step
    whole on one device."""
    cfg = get_config("granite-moe-1b-a400m")
    shape = dryrun.SHAPES["decode_32k"]
    mesh = dryrun.make_production_mesh(multi_pod=False)
    got = dryrun.step_counts(cfg, shape, mesh)
    alone = dryrun._count(cfg, shape, got["batch_per_dev"])
    assert 0 < got["flops"] < alone[0]
