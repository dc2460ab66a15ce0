"""Tensor parallelism and the sharded FSDP+TP train step over four gloo ranks on the CPU.

One process group of four ranks (spawned processes, a ``FileStore`` in a
temporary directory) runs every check once, on a (data 1, model 2) mesh of
ranks 0 and 1 and a (data 2, model 2) mesh of all four (and a (data 1,
model 4) mesh for the KV heads split inside a head); beside it a JAX
subprocess with 4 forced host devices runs the reference's own (2, 2)
sharded train step, as ``tests/test_distributed_integration.py`` does, on
the same weights (the port's, in the reference's layout).  The tests read
both.

- **Engine GEMMs.**  Every mode's column- and row-parallel GEMM of each
  rank's rows equals the unsharded GEMM's block: bit for bit for
  ``bitexact``, ``seqmul`` and ``inject`` (its noise drawn over the global
  (M, N)); ``lowrank`` within its rtol of 2e-6; ``exact`` and
  ``fakequant`` within rtol 1e-5, atol 1e-5 x max|want| (float32 partials
  added over the model group).  ``bitexact`` also at qwen3's ``w2`` K =
  3,072, where the integer partial sums matter.
- **Vocab-parallel CE**, loss and gradients, against the port's
  unsharded ``chunked_cross_entropy`` and ``cross_entropy_dense`` and the
  reference's ``chunked_cross_entropy`` (float32 tolerance: rtol 1e-5).
- **Decode over sequence-sharded caches.**  gemma2-9b ``.reduced(local_window=8)``:
  the logits of a prefill and 3 decode steps against ``mesh=None``
  (rtol/atol 2e-5), plain and ``attn_impl="pallas"`` (the decode's lse).
- **The sharded train step.**  Two qwen3-0.6b ``.reduced()`` steps with
  ``grad_accum=2`` at ``exact``: loss and parameters against ``mesh=None``
  and against the reference's (2, 2) step (loss rtol 1e-5, parameters
  atol 1e-6); the global norm against the unsharded one (rtol 1e-5); with
  8-bit moments and int8 compression against ``mesh=None``; and under
  ``bitexact`` on (1, 2) (the integer row sums) against ``mesh=None``.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
TIMEOUT_S = 300
MODES = ("exact", "bitexact", "seqmul", "inject", "lowrank", "fakequant")
INTEGER = ("bitexact", "seqmul", "inject")
GEMM_M, GEMM_K, GEMM_N = 8, 64, 32
ACCUM, BATCH, SEQ = 2, 8, 16

REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import TrainConfig
from repro.configs.registry import get_config
from repro.distributed.sharding import make_auto_mesh, mesh_context
from repro.launch import specs as S
from repro.models.registry import build_model
from repro.train.steps import init_train_state, make_train_step

z = np.load(sys.argv[1])
cfg = get_config("qwen3-0.6b").reduced()
model = build_model(cfg)
tcfg = TrainConfig(total_steps=4, grad_accum=2)
mesh = make_auto_mesh((2, 2), ("data", "model"))
out = {}
with mesh_context(mesh):
    state = init_train_state(model, tcfg, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(state.params)
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(z[f"leaf{i}"]) for i in range(len(leaves))])
    state = state._replace(params=params)
    state_sh = S.state_shardings(jax.eval_shape(lambda: state), mesh)
    state = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s) if hasattr(s, "spec") else x, state, state_sh)
    step = jax.jit(make_train_step(model, tcfg))
    for i in range(2):
        batch = {"tokens": jnp.asarray(z[f"tokens{i}"]), "labels": jnp.asarray(z[f"labels{i}"])}
        state, metrics = step(state, batch)
        out[f"loss{i}"] = np.asarray(metrics["loss"])
    for i, leaf in enumerate(jax.tree_util.tree_leaves(state.params)):
        out[f"leaf{i}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


def _qwen3():
    from repro_torch.configs.registry import get_config

    return get_config("qwen3-0.6b").reduced()


def _inputs(out: pathlib.Path) -> None:
    """The weights (the port's seeded init, in the reference's leaf order)
    and the two global batches."""
    from repro_torch.models.registry import STACKS, build_model, reference_leaves

    cfg = _qwen3()
    params = build_model(cfg).init_params(0, device="cpu")
    named = dict(params.named_parameters())
    leaves = [np.stack([named[n].detach().numpy() for n in leaf.names])
              if leaf.path[0] in STACKS else named[leaf.names[0]].detach().numpy()
              for leaf in reference_leaves(params)]
    rng = np.random.default_rng(0)
    data = {}
    for i in range(2):
        data[f"tokens{i}"] = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
        data[f"labels{i}"] = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    np.savez(out / "inputs.npz", **{f"leaf{i}": x for i, x in enumerate(leaves)}, **data)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("tensor_parallel")
    _inputs(out)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(out / "inputs.npz"),
         str(out / "reference.npz")], env={**_env(), "JAX_PLATFORMS": "cpu"}, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    workers = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(out)], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    for p in workers + [ref]:
        _, err = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, err[-4000:]
    ranks = [pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    return dict(ranks=ranks, ref=dict(np.load(out / "reference.npz")),
                inputs=dict(np.load(out / "inputs.npz")))


def _mine(res: dict, key: str):
    return [r[key] for r in res if key in r]


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("role", ["column", "row"])
def test_engine_gemm_shard_equals_the_unsharded_block(group, mesh, mode, role):
    got = _mine(group["ranks"], f"gemm/{mesh}/{mode}/{role}")
    assert len(got) == (2 if mesh == "1x2" else 4)
    for have, want in got:
        if mode in INTEGER:
            assert np.array_equal(have, want), np.abs(have - want).max()
        elif mode == "lowrank":
            np.testing.assert_allclose(have, want, rtol=2e-6, atol=2e-6 * np.abs(want).max())
        else:
            np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_row_shards_add_exact_integer_sums_past_two_to_the_24(group):
    """qwen3's w2 K = 3,072 at n = 8: partial sums past 2^24, still bit-equal."""
    for have, want, big in _mine(group["ranks"], "gemm/w2"):
        assert big >= 2**24
        assert np.array_equal(have, want)


def test_vocab_parallel_cross_entropy(group):
    import jax.numpy as jnp

    from repro.train.losses import chunked_cross_entropy as ref_ce

    from repro_torch.train.losses import cross_entropy_dense

    for res in _mine(group["ranks"], "ce"):
        h, w, lab = (torch.from_numpy(res[k]) for k in ("h", "w", "labels"))
        dense = cross_entropy_dense(h @ w, lab)
        ref = float(ref_ce(jnp.asarray(res["h"]), jnp.asarray(res["w"]),
                           jnp.asarray(res["labels"]), v_chunk=48))
        for want in (res["whole"], float(dense), ref):
            np.testing.assert_allclose(res["sharded"], want, rtol=1e-5)
        np.testing.assert_allclose(res["dh"], res["dh_whole"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(res["dw"], res["dw_whole"], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_decode_over_sequence_sharded_caches_matches_unsharded(group, attn, mesh):
    got = _mine(group["ranks"], f"decode/{mesh}/{attn}")
    assert got
    for steps in got:
        assert len(steps) == 4  # the prefill and 3 decode steps
        for have, want in steps:
            np.testing.assert_allclose(have, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("tier", ["exact", "balanced", "draft"])
def test_scheduler_on_a_data_model_mesh_serves_the_unsharded_streams(group, tier):
    got = _mine(group["ranks"], f"serve/{tier}")
    assert len(got) == WORLD
    for want, have in got:
        assert want.keys() == have.keys()
        for rid in want:
            assert np.array_equal(have[rid], want[rid]), rid


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "1x4"])
def test_sharded_train_steps_match_unsharded(group, mesh):
    got = _mine(group["ranks"], f"train/{mesh}")
    assert got
    for res in got:
        np.testing.assert_allclose(res["loss"], res["loss_whole"], rtol=1e-5)
        np.testing.assert_allclose(res["grad_norm"], res["grad_norm_whole"], rtol=1e-5)
        for have, want in zip(res["params"], res["params_whole"]):
            np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-6)


def test_sharded_train_steps_match_the_reference_sharded_step(group):
    ref = group["ref"]
    res = _mine(group["ranks"], "train/2x2")[0]
    np.testing.assert_allclose(res["loss"], [float(ref["loss0"]), float(ref["loss1"])],
                               rtol=1e-5)
    for i, have in enumerate(res["params_ref_order"]):
        np.testing.assert_allclose(have, ref[f"leaf{i}"], rtol=1e-5, atol=1e-6)


def test_one_rank_mesh_train_steps_are_the_unsharded_bits(group):
    """bf16, bitexact mlp+attn on a one-rank (1, 1) mesh: the losses, grad
    norms and parameters of two steps equal ``mesh=None``'s bit for bit."""
    assert _mine(group["ranks"], "train-1x1-bits") == [True]


@pytest.mark.parametrize("what", ["q8-compress", "bitexact", "subhead", "tp-only"])
def test_sharded_train_step_variants_match_unsharded(group, what):
    got = _mine(group["ranks"], f"train-{what}")
    assert got
    for res in got:
        np.testing.assert_allclose(res["loss"], res["loss_whole"], rtol=1e-5)
        for have, want in zip(res["params"], res["params_whole"]):
            np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-6)


def test_sharded_step_refuses_a_state_placed_on_another_mesh(group):
    assert _mine(group["ranks"], "train-wrong-mesh") == [True] * WORLD


def test_global_norm_counts_each_element_once(group):
    for res in _mine(group["ranks"], "norm"):
        np.testing.assert_allclose(res["sharded"], res["whole"], rtol=1e-6)
        # a replicated leaf counted once per replica would not match
        assert not np.isclose(res["sharded"], res["overcounted"], rtol=1e-3)


def test_collectives_are_counted_by_kind(group):
    from repro_torch.distributed.sharding import RS_AS_ALL_REDUCE

    for counts in _mine(group["ranks"], "counts"):
        assert counts["all-gather"] > 0 and counts["all-reduce"] > 0
        assert counts[RS_AS_ALL_REDUCE] > 0


def test_reduce_scatter_counts_the_all_reduce_it_issues():
    """A reduce-scatter runs as an all-reduce of the whole buffer (gloo has
    none), and is counted at that buffer's bytes."""
    from repro_torch.distributed import sharding

    ax = sharding.Axis("data", None, 1, 4)
    t = torch.empty((8, 16), device="meta")
    with sharding.counting() as counts:
        out = sharding.reduce_scatter(t, ax, 0)
    assert tuple(out.shape) == (2, 16)
    assert dict(counts) == {sharding.RS_AS_ALL_REDUCE: 8 * 16 * 4}


@pytest.mark.parametrize("total,ranks,s,b", [(16, 2, 1, 4), (16, 4, 5, 3), (16, 2, 16, 2),
                                             (24, 4, 7, 5)])
def test_sequence_shard_writes_equal_the_whole_cache_write(total, ranks, s, b):
    """Each rank's write into its slots of a sequence-split cache (rows at
    per-row starts, some past the end and clamped, some spanning ranks)
    gives the whole cache's write."""
    from repro_torch.models.attention import _write_range, _write_rows

    g = torch.Generator().manual_seed(total * ranks + s)
    t = total // ranks
    for _ in range(16):
        starts = torch.randint(-3, total + 3, (b,), generator=g)
        update = torch.randn((b, s, 2, 3), generator=g)
        cache = torch.randn((b, total, 2, 3), generator=g)
        want = cache.clone()
        _write_rows(want, update, starts)
        parts = [cache[:, r * t:(r + 1) * t].clone() for r in range(ranks)]
        for r, part in enumerate(parts):
            _write_range(part, update, starts, r * t, total)
        assert torch.equal(torch.cat(parts, 1), want), starts


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "1x4"])
def test_from_jax_params_places_each_leaf_block(group, mesh):
    got = _mine(group["ranks"], f"load/{mesh}")
    assert got and all(got)


def test_checkpoint_of_the_sharded_state_restores_unsharded(group):
    for ok, n in _mine(group["ranks"], "ckpt"):
        assert ok == n


# ------------------------------------------------- single-process checks
@pytest.mark.parametrize("mode", INTEGER)
def test_integer_epilogue_plain_versions_match_the_float_outputs(mode):
    from repro_torch.engine import artifacts
    from repro_torch.kernels import lut_matmul, packed_matmul, seqmul_matmul

    rng = np.random.default_rng(1)
    n = 8
    for k in (96, 40000):  # int32 sums, and int64 past int32_k_limit
        m, n_cols = 2, 3
        ma = torch.from_numpy(rng.integers(0, 1 << n, (m, k)).astype(np.int64))
        mb = torch.from_numpy(rng.integers(0, 1 << n, (k, n_cols)).astype(np.int64))
        sa = torch.from_numpy(rng.choice([-1, 1], (m, k)).astype(np.int8))
        sb = torch.from_numpy(rng.choice([-1, 1], (k, n_cols)).astype(np.int8))
        if mode == "bitexact":
            lut = artifacts.product_lut_u16(n, 4, True, torch.device("cpu"))
            f = lambda integer: lut_matmul.lut_matmul_plain(lut, ma, sa, mb, sb, n=n,
                                                            integer=integer)
            dtype = lut_matmul.int_dtype(k, n)
        elif mode == "seqmul":
            if k > 1000:
                continue  # the recurrence cube; int64 is held by the kernel contract below
            f = lambda integer: seqmul_matmul.seqmul_matmul_plain(ma, sa, mb, sb, n=n, t=4,
                                                                  integer=integer)
            dtype = seqmul_matmul.int_dtype(k, n)
        else:
            pa = packed_matmul.pack_i16_pairs(ma * sa.to(torch.int64), dim=1)
            pb = packed_matmul.pack_i16_pairs(mb * sb.to(torch.int64), dim=0)
            f = lambda integer: packed_matmul.packed_matmul_plain(pa, pb, n=n, integer=integer)
            dtype = packed_matmul.int_dtype(pa.shape[1], n)
        got, want = f(True), f(False)
        assert got.dtype == dtype
        assert dtype == (torch.int64 if k > 40000 // 2 else torch.int32) or mode == "inject"
        assert torch.equal(got.to(torch.float32), want)


def test_integer_epilogue_and_row_routes_are_certified_and_the_gate_refuses_others(
        monkeypatch):
    from repro_torch.analysis import audit, contracts
    from repro_torch.kernels.build import audit_gate

    for kind, (n, t) in (("lut_gemm_int", (8, 4)), ("seqmul_gemm_int", (12, 6)),
                         ("packed_gemm_int", (8, 4))):
        assert audit.audit_kernel(contracts.kernel_trace(kind, n, t)).certified, kind
    for mode in INTEGER:
        assert audit.certified_row(mode, 8, 4, 2) and audit.certified_row(mode, 8, 4, 4)
    assert not audit.certified_row("seqmul", 13, 6, 2)  # past the dispatch contract
    assert not audit.certified_kernel("seqmul_gemm_int", 16, 8)  # past its carriers
    with pytest.raises(ValueError, match="integer partials"):
        contracts.gemm_trace("lowrank", 8, 4, shards=2)
    monkeypatch.setenv("REPRO_STATIC_AUDIT", "1")
    audit_gate("lut_matmul", "lut_gemm_int", 8, 4)
    audit_gate("engine.matmul", "row:bitexact", 8, 4, shards=4)
    with pytest.raises(audit.CertificationError):
        audit_gate("engine.matmul", "row:seqmul", 13, 6, shards=2)
    with pytest.raises(audit.CertificationError):
        audit_gate("seqmul_matmul", "seqmul_gemm_int", 16, 8)


def test_combine_ranges_equals_attention_over_the_union():
    from repro_torch.kernels.flash_attention import combine_ranges, flash_decode_plain

    gen = torch.Generator().manual_seed(0)
    b, h, kv, hd, t = 3, 4, 2, 16, 64
    q = torch.randn((b, h, hd), generator=gen)
    k, v = (torch.randn((b, t, kv, hd), generator=gen) for _ in range(2))
    q_pos = torch.tensor([40, 63, 5])
    k_pos = torch.arange(t)[None].expand(b, t).clone()
    k_pos[2] = -1  # a row with no allowed slot: the uniform average of every slot
    want, want_lse = flash_decode_plain(q, k, v, q_pos, k_pos, window=24, with_lse=True)
    for parts in (2, 4):
        step = t // parts
        got = [flash_decode_plain(q, k[:, i * step:(i + 1) * step], v[:, i * step:(i + 1) * step],
                                  q_pos, k_pos[:, i * step:(i + 1) * step], window=24,
                                  with_lse=True) for i in range(parts)]
        o, lse = combine_ranges(torch.stack([g[0] for g in got]), torch.stack([g[1] for g in got]))
        torch.testing.assert_close(o, want, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(lse[:2], want_lse[:2], rtol=2e-5, atol=2e-5)


def test_dryrun_counts_the_sharded_step_collectives():
    """The counterpart of the reference's analyzer test: a sharded matmul
    chain's gradient issues collectives; qwen3-0.6b train_4k on the 16 x 16
    pod has its bytes by kind, and so do the other families' (mamba2's
    SSD, kimi-k2's MoE over sequence-sharded residuals)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch import dryrun
    from repro_torch.models.layers import Ctx, dense

    mesh = AbstractMesh((2, 4), ("data", "model"))
    x = torch.empty((16, 64), device="meta", requires_grad=True)
    w1 = torch.nn.Parameter(torch.empty((64, 128 // 4), device="meta"))
    w2 = torch.nn.Parameter(torch.empty((128 // 4, 64), device="meta"))
    w1.spec, w2.spec = (None, "model"), ("model", None)
    ctx = Ctx(cfg=get_config("qwen3-0.6b").reduced())
    with sharding.mesh_context(mesh), sharding.counting() as counts:
        h = torch.tanh(dense(x, w1, ctx))
        dense(h, w2, ctx).sum().backward()
    assert sum(counts.values()) > 0 and counts["all-reduce"] > 0

    rec = dryrun.size_cell("qwen3-0.6b", "train_4k", False)
    coll = rec["collective_bytes_per_dev"]
    assert coll is not None and sum(coll.values()) > 0, rec
    assert rec["terms_s"]["collective"] > 0
    for arch in ("mamba2-130m", "kimi-k2-1t-a32b"):
        rec = dryrun.size_cell(arch, "train_4k", False)
        coll = rec["collective_bytes_per_dev"]
        assert coll is not None, rec
        for kind in ("all-gather", "all-reduce", sharding.RS_AS_ALL_REDUCE):
            assert coll[kind] > 0, (arch, kind, coll)
        assert rec["terms_s"]["collective"] > 0


def test_dryrun_flops_per_dev_are_one_rank_blocks():
    """A reduced qwen3-0.6b decode step on a (2, 2) mesh, counted by hand:
    every projection and the head split over the model axis, the attention
    with every head over this rank's half of the cache slots, the batch
    over the data axis."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch import dryrun

    cfg = get_config("qwen3-0.6b").reduced()
    shape = ShapeConfig("decode_small", 64, 8, "decode")
    got = dryrun.step_counts(cfg, shape, AbstractMesh((2, 2), ("data", "model")))
    b, m, t = 4, 2, 64  # the rows a data rank holds, the model ranks, the cache slots
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    layer = (2 * b * d * (hq + 2 * hkv) / m  # q, k and v, column-parallel
             + 2 * b * hq / m * d  # wo, row-parallel
             + 3 * 2 * b * d * ff / m  # w1, w3 and w2
             + 4 * b * cfg.num_heads * (t / m) * cfg.head_dim)  # q.k and p.v
    assert got["batch_per_dev"] == b
    assert got["flops"] == cfg.num_layers * layer + 2 * b * d * v / m  # and the head


# --------------------------------------------------------------- the ranks
def _np(t):
    return t.detach().to(torch.float32).numpy().copy()


def _gemm_checks(meshes: dict, res: dict) -> None:
    from repro_torch.distributed import sharding
    from repro_torch.engine import dispatch
    from repro_torch.engine.modes import quantize_operands

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((GEMM_M, GEMM_K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((GEMM_K, GEMM_N)) * 0.1).astype(np.float32))
    # one-signed operands, so that the sums pass 2^24 (float32 partials would round)
    w2 = torch.from_numpy((np.abs(rng.standard_normal((3072, 16))) + 1).astype(np.float32))
    x2 = torch.from_numpy((np.abs(rng.standard_normal((4, 3072))) + 1).astype(np.float32))

    def mm(a, b, mode, shard=None):
        gen = torch.Generator().manual_seed(0)
        return dispatch.matmul(a, b, mode=mode, n=8, t=4, generator=gen, backend="reference",
                               shard=shard)

    with torch.no_grad():
        whole = {mode: mm(x, w, mode) for mode in MODES}
        for label, mesh in meshes.items():
            if mesh.get_coordinate() is None:
                continue
            d = sharding.mesh_axis(mesh, "data")
            ax = sharding.model_axis(mesh)
            rows = slice(d.index * GEMM_M // d.size, (d.index + 1) * GEMM_M // d.size)
            cols = slice(ax.index * GEMM_N // ax.size, (ax.index + 1) * GEMM_N // ax.size)
            ks = slice(ax.index * GEMM_K // ax.size, (ax.index + 1) * GEMM_K // ax.size)
            with sharding.mesh_context(mesh):
                for mode in MODES:
                    col = mm(x[rows], w[:, cols], mode, sharding.Shard("column", ax))
                    row = mm(x[rows, ks], w[ks], mode, sharding.Shard("row", ax))
                    res[f"gemm/{label}/{mode}/column"] = (_np(col), _np(whole[mode][rows, cols]))
                    res[f"gemm/{label}/{mode}/row"] = (_np(row), _np(whole[mode][rows]))
                if label == "1x2":
                    ks2 = slice(ax.index * 1536, (ax.index + 1) * 1536)
                    got = mm(x2[:, ks2], w2[ks2], "bitexact", sharding.Shard("row", ax))
                    want = mm(x2, w2, "bitexact")
                    (mx, _), (mw, _), _ = quantize_operands(x2, w2, 8)
                    big = int((mx.to(torch.float64) @ mw.to(torch.float64)).abs().max())
                    res["gemm/w2"] = (_np(got), _np(want), big)


def _ce_checks(mesh, res: dict) -> None:
    from repro_torch.distributed import sharding
    from repro_torch.train.losses import chunked_cross_entropy

    if mesh.get_coordinate() is None:
        return
    rng = np.random.default_rng(3)
    b, s, dm, v = 2, 5, 16, 200
    h = rng.standard_normal((b, s, dm)).astype(np.float32)
    w = (rng.standard_normal((dm, v)) * 0.3).astype(np.float32)
    lab = rng.integers(0, v, (b, s)).astype(np.int64)
    ax = sharding.model_axis(mesh)
    vl = v // ax.size
    out = {"h": h, "w": w, "labels": lab}
    ht, wt = torch.tensor(h, requires_grad=True), torch.tensor(w, requires_grad=True)
    loss = chunked_cross_entropy(ht, wt, torch.from_numpy(lab), v_chunk=48)
    loss.backward()
    out.update(whole=float(loss), dh_whole=_np(ht.grad), dw_whole=_np(wt.grad))
    hs = torch.tensor(h, requires_grad=True)
    ws = torch.tensor(w[:, ax.index * vl:(ax.index + 1) * vl], requires_grad=True)
    with sharding.mesh_context(mesh):
        loss = chunked_cross_entropy(hs, ws, torch.from_numpy(lab), v_chunk=48, vocab_axis=ax)
        loss.backward()
    dw = sharding.gather(ws.grad, ax, 1)
    out.update(sharded=float(loss), dh=_np(hs.grad), dw=_np(dw))
    res["ce"] = out


def _decode_checks(meshes: dict, res: dict) -> None:
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    base = get_config("gemma2-9b").reduced(local_window=8)
    rng = np.random.default_rng(4)
    b, prompt, max_seq = 4, 8, 16
    tokens = torch.from_numpy(rng.integers(0, base.vocab_size, (b, prompt)))
    for attn in ("xla", "pallas"):
        cfg = dataclasses.replace(base, attn_impl=attn)
        model = build_model(cfg)
        prefill, decode = make_prefill_step(model, max_seq), make_decode_step(model)

        def run(params, rows):
            caches, logits = prefill(params, {"tokens": tokens[rows]})
            outs = [logits]
            tok = torch.from_numpy(np.arange(b)[rows, None] % 7 + 3)
            for i in range(3):
                logits, caches = decode(params, caches, tok, prompt + i)
                outs.append(logits)
            return outs

        with torch.no_grad():
            want = run(model.init_params(0, device="cpu"), slice(0, b))
            for label, mesh in meshes.items():
                if mesh.get_coordinate() is None:
                    continue
                d = sharding.mesh_axis(mesh, "data")
                rows = slice(d.index * b // d.size, (d.index + 1) * b // d.size)
                with sharding.mesh_context(mesh):
                    got = run(model.init_params(0, device="cpu", mesh=mesh), rows)
                res[f"decode/{label}/{attn}"] = [(_np(g), _np(w[rows])) for g, w in zip(got, want)]


def _serve_checks(mesh, res: dict) -> None:
    """The continuous scheduler on a (data, model) mesh with placed parameters."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ContinuousScheduler, synth_requests

    if mesh.get_coordinate() is None:
        return
    cfg = get_config("qwen3-0.6b").reduced()
    model = build_model(cfg)
    queue = synth_requests(6, prompt_len=8, gen=4, vocab_size=cfg.vocab_size, seed=0)
    for tier in ("exact", "balanced", "draft"):
        runs = [ContinuousScheduler(model, model.init_params(0, device="cpu", mesh=m),
                                    batch_size=4, prompt_len=8, max_new=4, mesh=m,
                                    quality=tier).run(queue, warmup=False)
                for m in (None, mesh)]
        res[f"serve/{tier}"] = (runs[0].outputs, runs[1].outputs)


def _full_params(state, mesh, model):
    """Every parameter whole, by name, from a sharded state."""
    from repro_torch.distributed import sharding

    names = [n for n, _ in model.init_params(0, device="meta").named_parameters()]
    return {n: _np(sharding.gather_block(p.local, p.spec, mesh)) for n, p in
            zip(names, state.params)}


def _train(mesh, tcfg, cfg, inputs, steps=2, load=True, fsdp=True):
    """(losses, grad norms, whole params by name, state) of ``steps`` train
    steps from the inputs' weights (``load``) or the seeded init; on a
    mesh, the state placed with or without ``fsdp``."""
    from repro_torch.checkpoint.manager import shard_train_state
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import init_train_state, make_train_step, shard_batch

    model = build_model(cfg)
    state = init_train_state(model, tcfg, 0, device="cpu")
    if load:
        with torch.no_grad():
            for (_, p), (_, q) in zip(state.params.named_parameters(),
                                      _loaded(cfg, inputs).named_parameters()):
                p.copy_(q)
    if mesh is not None:
        state = shard_train_state(state, mesh, fsdp=fsdp)
    step = make_train_step(model, tcfg, mesh=mesh)
    losses, norms = [], []
    for i in range(steps):
        batch = {"tokens": torch.from_numpy(inputs[f"tokens{i}"]).long(),
                 "labels": torch.from_numpy(inputs[f"labels{i}"]).long()}
        if mesh is not None:
            batch = shard_batch(batch, mesh, tcfg.grad_accum)
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    if mesh is None:
        params = {n: _np(p) for n, p in state.params.named_parameters()}
    else:
        params = _full_params(state, mesh, model)
    return losses, norms, params, state


def _tree(cfg, inputs) -> dict:
    """The inputs' weights as the reference's parameter tree (numpy leaves)."""
    from repro_torch.models.registry import STACKS, build_model, reference_leaves, to_jax_layout

    meta = build_model(cfg).init_params(0, device="meta")
    named = {}
    for i, leaf in enumerate(reference_leaves(meta)):
        arr = inputs[f"leaf{i}"]
        for j, n in enumerate(leaf.names):
            named[n] = arr[j] if leaf.path[0] in STACKS else arr
    return to_jax_layout(named, meta)


def _loaded(cfg, inputs, mesh=None):
    from repro_torch.models.registry import from_jax_params

    return from_jax_params(_tree(cfg, inputs), cfg, device="cpu", mesh=mesh)


def _train_checks(meshes: dict, out: pathlib.Path, res: dict) -> None:
    import dataclasses

    from repro_torch.checkpoint.manager import CheckpointManager, state_leaves
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import apply_approx
    from repro_torch.models.registry import build_model, reference_leaves
    from repro_torch.distributed import sharding
    from repro_torch.train.steps import make_train_step

    inputs = dict(np.load(out / "inputs.npz"))
    cfg = _qwen3()
    tcfg = TrainConfig(total_steps=4, grad_accum=ACCUM)
    if meshes["1x1"].get_coordinate() is not None:
        # one rank, bf16 and bitexact: every collective an identity, the same bits
        bf16 = apply_approx(dataclasses.replace(cfg, dtype="bfloat16"), mode="bitexact", n=8,
                            t=4, targets=("mlp", "attn"))
        want, got = (_train(m, tcfg, bf16, inputs, load=False) for m in (None, meshes["1x1"]))
        res["train-1x1-bits"] = (want[0] == got[0] and want[1] == got[1] and all(
            np.array_equal(got[2][n], a) for n, a in want[2].items()))
    whole = _train(None, tcfg, cfg, inputs)
    for label, mesh in meshes.items():
        if mesh.get_coordinate() is None or label == "1x1":
            continue
        placed, full = _loaded(cfg, inputs, mesh), dict(_loaded(cfg, inputs).named_parameters())
        res[f"load/{label}"] = all(torch.equal(p, sharding.local_block(full[n], p.spec, mesh))
                                   for n, p in placed.named_parameters())
        with sharding.counting() as counts:
            got = _train(mesh, tcfg, cfg, inputs)
        names = list(whole[2])
        item = dict(loss=got[0], loss_whole=whole[0], grad_norm=got[1], grad_norm_whole=whole[1],
                    params=[got[2][n] for n in names], params_whole=[whole[2][n] for n in names])
        if label == "2x2":
            res["counts"] = dict(counts)
            params = build_model(cfg).init_params(0, device="meta")
            item["params_ref_order"] = [
                np.stack([got[2][n] for n in leaf.names]) if leaf.path[0] == "scan"
                else got[2][leaf.names[0]] for leaf in reference_leaves(params)]
            # the global norm: each element once, not once per replica
            res["norm"] = dict(sharded=got[1][0], whole=whole[1][0],
                               overcounted=float(np.sqrt(sum(
                                   (np.square(v).sum() * (4 if v.ndim == 1 else 1))
                                   for v in whole[2].values()))))
            # the sharded state saves whole and restores onto one device
            mgr = CheckpointManager(str(out / "ckpt"))
            mgr.save(2, got[3], blocking=True)
            torch.distributed.barrier()  # the origin has written it
            target = _train(None, tcfg, cfg, inputs, steps=0)[3]
            CheckpointManager(str(out / "ckpt")).restore(target)
            ok = sum(np.array_equal(_np(a), got[2][n]) for (n, a) in
                     target.params.named_parameters())
            res["ckpt"] = (ok, len(names))
            del state_leaves
        res[f"train/{label}"] = item
    mesh = meshes["1x4"]  # two query heads on four ranks: q whole too
    two = dataclasses.replace(cfg, num_heads=2, num_kv_heads=1)
    want, got = (_train(m, tcfg, two, inputs, 1, load=False) for m in (None, mesh))
    res["train-subhead"] = dict(loss=got[0], loss_whole=want[0], params=list(got[2].values()),
                                params_whole=list(want[2].values()))
    mesh = meshes["2x2"]
    q8 = dataclasses.replace(tcfg, opt_state_bits=8, grad_compress_bits=8)
    want, got = _train(None, q8, cfg, inputs, steps=1), _train(mesh, q8, cfg, inputs, steps=1)
    res["train-q8-compress"] = dict(loss=got[0], loss_whole=want[0],
                                    params=list(got[2].values()),
                                    params_whole=list(want[2].values()))
    # parameters and moments split over the model axis only: the step
    # takes each block's spec from the state
    got = _train(mesh, tcfg, cfg, inputs, steps=1, fsdp=False)
    want = _train(None, tcfg, cfg, inputs, steps=1)
    res["train-tp-only"] = dict(loss=got[0], loss_whole=want[0],
                                params=list(got[2].values()), params_whole=list(want[2].values()))
    try:  # a state placed on the (2, 2) mesh, stepped on the (1, 4) one
        make_train_step(build_model(cfg), tcfg, mesh=meshes["1x4"])(got[3], {})
    except ValueError as e:
        res["train-wrong-mesh"] = "another mesh" in str(e)
    mesh = meshes["1x2"]
    if mesh.get_coordinate() is not None:
        approx = apply_approx(cfg, mode="bitexact", n=8, t=4, targets=("mlp", "attn"))
        want, got = _train(None, tcfg, approx, inputs, 1), _train(mesh, tcfg, approx, inputs, 1)
        res["train-bitexact"] = dict(loss=got[0], loss_whole=want[0],
                                     params=list(got[2].values()),
                                     params_whole=list(want[2].values()))


def _worker(rank: int, world: int, out: pathlib.Path) -> None:
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    torch.set_num_threads(1)
    store = torch.distributed.FileStore(str(out / "store"), world)
    torch.distributed.init_process_group("gloo", store=store, rank=rank, world_size=world)
    res: dict = {}
    try:
        names = ("data", "model")
        meshes = {"1x1": DeviceMesh("cpu", torch.arange(1)[None, :], mesh_dim_names=names),
                  "1x2": DeviceMesh("cpu", torch.arange(2)[None, :], mesh_dim_names=names),
                  "2x2": init_device_mesh("cpu", (2, 2), mesh_dim_names=names),
                  "1x4": init_device_mesh("cpu", (1, 4), mesh_dim_names=names)}
        pair = {k: meshes[k] for k in ("1x2", "2x2")}
        _gemm_checks(pair, res)
        _ce_checks(meshes["1x2"], res)
        _decode_checks(pair, res)
        _serve_checks(meshes["2x2"], res)
        _train_checks(meshes, out, res)
    finally:
        torch.distributed.destroy_process_group()
    (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3]))
