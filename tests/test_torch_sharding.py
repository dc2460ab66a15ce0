"""The port's sharding rules, specs and dry-run sizes against the JAX package's.

Single process, no process group: the specs are pure functions of paths,
shapes and axis sizes.  The reference's own cases
(``tests/test_sharding_specs.py``) run through both packages; then every
parameter leaf of every arch in ``list_archs()``, at the pod and two-pod
production meshes with FSDP on and off, is compared entry by entry with the
reference's ``param_spec`` over ``jax.eval_shape`` of its parameters; the
batch, cache and train-state specs of every ``shapes_for`` cell with the
reference's shardings over an ``AbstractMesh``; and the dry-run's
per-device bytes with the sum over the reference's leaves of size / shards
x itemsize.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import list_archs as jax_list_archs
from repro.configs.registry import shapes_for as jax_shapes_for
from repro.distributed import sharding as jax_sharding
from repro.launch import specs as jax_specs
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs.registry import get_config, list_archs, shapes_for
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.registry import build_model

SIZES = {"pod": 2, "data": 16, "model": 16}
MESHES = {"multi": SIZES, "single": {"data": 16, "model": 16}}
SCALE_ARCHS = ("yi-9b", "kimi-k2-1t-a32b", "mamba2-130m", "seamless-m4t-large-v2")


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(arch: str):
    model = jax_build_model(jax_get_config(arch))
    shapes = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    return [(_path(kp), tuple(v.shape), np.dtype(v.dtype))
            for kp, v in jax.tree_util.tree_flatten_with_path(shapes)[0]]


@functools.lru_cache(maxsize=None)
def _port_params(arch: str):
    return build_model(get_config(arch)).init_params(0, device="meta")


def _mesh(sizes: dict) -> sharding.AbstractMesh:
    return sharding.AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _jax_mesh(sizes: dict):
    return JaxAbstractMesh(tuple(sizes.values()), tuple(sizes))


def test_list_archs_and_shapes_for_match():
    assert list_archs() == jax_list_archs()
    assert list_archs(include_paper=True) == jax_list_archs(include_paper=True)
    for arch in list_archs(include_paper=True):
        want = jax_shapes_for(jax_get_config(arch))
        got = shapes_for(get_config(arch))
        assert list(got) == list(want)
        for name in want:
            assert dataclass_tuple(got[name]) == dataclass_tuple(want[name])


def dataclass_tuple(shape):
    return (shape.name, shape.seq_len, shape.global_batch, shape.kind)


def test_resolve_entry_divisibility():
    cases = [("model", 64), ("model", 28), (("pod", "data"), 256), (("pod", "data"), 2),
             (("pod", "data"), 3), ("absent", 64), (None, 64)]
    for entry, dim in cases:
        assert sharding._resolve_entry(entry, dim, SIZES) == jax_sharding._resolve_entry(
            entry, dim, SIZES)
    assert sharding._resolve_entry(("pod", "data"), 2, SIZES) == "pod"  # prefix shrink
    assert sharding._resolve_entry("model", 28, SIZES) is None


def test_resolve_spec_shapes():
    spec, shape = (("pod", "data"), None, "model"), (256, 7, 4096)
    got = sharding.resolve_spec(spec, shape, SIZES)
    assert got == tuple(jax_sharding.resolve_spec(spec, shape, SIZES))
    assert got == (("pod", "data"), None, "model")


PARAM_CASES = [
    ("embed", (64000, 4096)), ("embed", (49155, 1024)), ("scan/sub0/attn/wq", (4096, 4096)),
    ("scan/sub0/attn/wo", (4096, 4096)), ("scan/sub0/ffn/w1", (12, 4096, 11008)),
    ("scan/sub0/ffn_moe/we1", (32, 1024, 512)), ("scan/sub0/ln1", (4096,)),
    ("scan/sub0/unmatched", (24, 1024, 48)), ("unmatched", (7,)),
]


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no-fsdp"])
def test_param_spec_rules(fsdp):
    for path, shape in PARAM_CASES:
        got = sharding.param_spec(path, shape, SIZES, fsdp=fsdp)
        assert got == tuple(jax_sharding.param_spec(path, shape, SIZES, fsdp=fsdp)), path
    if fsdp:
        assert sharding.param_spec("embed", (64000, 4096), SIZES) == ("model", "data")
        assert sharding.param_spec("embed", (49155, 1024), SIZES) == (None, "data")
        assert sharding.param_spec("scan/sub0/ffn/w1", (12, 4096, 11008), SIZES) == (
            None, "data", "model")
        assert sharding.param_spec("scan/sub0/ln1", (4096,), SIZES) == ()


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no-fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jax_list_archs())
def test_param_specs_match_reference_leaf_by_leaf(arch, mesh, fsdp):
    sizes = MESHES[mesh]
    want = _jax_param_shapes(arch)
    got = sharding.leaf_specs(_port_params(arch), _mesh(sizes), fsdp=fsdp)
    assert [sharding._path_str(ls.path) for ls in got] == [p for p, _, _ in want]
    # the port's per-layer tensors: the stacked entry dropped
    per_layer = sharding.param_specs(_port_params(arch), _mesh(sizes), fsdp=fsdp)
    for ls, (path, shape, _) in zip(got, want):
        assert ls.shape == shape, path
        assert ls.spec == tuple(jax_sharding.param_spec(path, shape, sizes, fsdp=fsdp)), path
        for name in ls.names:
            assert per_layer[name] == (ls.spec[1:] if ls.stacked and ls.spec else ls.spec)
        # the reference's fits-at-scale proxy on its four archs: >= 16M elements sharded
        if fsdp and arch in SCALE_ARCHS and math.prod(shape) >= (1 << 24):
            assert any(s is not None for s in ls.spec), path


def _jax_cells(arch: str):
    cfg = jax_get_config(arch)
    return [(name, cell) for name, cell in jax_shapes_for(cfg).items()]


CELLS = [(arch, name) for arch in jax_list_archs() for name, _ in _jax_cells(arch)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_batch_cache_and_state_specs_match_reference(arch, shape_name, mesh):
    sizes = MESHES[mesh]
    jmesh = _jax_mesh(sizes)
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jshape, shape = jax_shapes_for(jcfg)[shape_name], shapes_for(cfg)[shape_name]
    # batch
    jbatch = (jax_specs.input_specs(jcfg, jshape) if shape.kind != "decode"
              else jax_specs.decode_input_specs(jcfg, jshape))
    batch = (specs.input_specs(cfg, shape) if shape.kind != "decode"
             else specs.decode_input_specs(cfg, shape))
    assert sorted(batch) == sorted(jbatch)
    want = {k: tuple(s.spec) for k, s in jax_specs.batch_shardings(jbatch, jmesh).items()}
    got = specs.batch_specs(batch, _mesh(sizes))
    for name in want:
        assert tuple(batch[name].shape) == tuple(jbatch[name].shape), name
        assert str(batch[name].dtype).removeprefix("torch.") == str(jbatch[name].dtype), name
        assert got[name] == want[name], name
    # caches (decode cells)
    if shape.kind == "decode":
        mem = jax_specs.ENC_MEM_LEN_DECODE if jcfg.is_encdec else 0
        jmodel = jax_build_model(jcfg)
        jc = jax.eval_shape(functools.partial(jmodel.init_caches, jshape.global_batch,
                                              jshape.seq_len, jnp.bfloat16, mem_len=mem))
        jsh = jax_specs.cache_shardings(jc, jmesh)
        jleaves = jax.tree_util.tree_flatten_with_path(jc)[0]
        caches = build_model(cfg).init_caches(shape.global_batch, shape.seq_len,
                                              torch.bfloat16, "meta", mem_len=mem)
        got = specs.cache_specs(cfg, caches, _mesh(sizes))
        assert len(got) == len(jleaves)
        for (leaf, spec), (kp, x), s in zip(got, jleaves, jax.tree_util.tree_leaves(jsh)):
            assert leaf.shape == tuple(x.shape), jax.tree_util.keystr(kp)
            assert str(leaf.dtype).removeprefix("torch.") == str(x.dtype)
            assert spec == tuple(s.spec), jax.tree_util.keystr(kp)
    # train state: the moments mirror the parameters' specs, the step replicated
    if shape.kind == "train":
        st = specs.state_specs(_port_params(arch), _mesh(sizes))
        want = [tuple(jax_sharding.param_spec(p, sh, sizes)) for p, sh, _ in
                _jax_param_shapes(arch)]
        assert [ls.spec for ls in st["params"]] == want
        assert st["mu"] == st["nu"] == [w if sh else () for w, (_, sh, _) in
                                        zip(want, _jax_param_shapes(arch))]
        assert st["step"] == ()


def _ref_bytes(arch: str, shape_name: str, sizes: dict) -> dict:
    """Per-device bytes from the reference's own specs and shapes."""
    jmesh = _jax_mesh(sizes)
    jcfg = jax_get_config(arch)
    jshape = jax_shapes_for(jcfg)[shape_name]

    def nbytes(shape, dtype, spec):
        shards = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                shards *= sizes[a]
        return math.prod(shape) // shards * np.dtype(dtype).itemsize

    out = {"params": 0, "opt": 0, "caches": 0, "batch": 0}
    for path, shape, dtype in _jax_param_shapes(arch):
        spec = jax_sharding.param_spec(path, shape, sizes)
        out["params"] += nbytes(shape, dtype, spec)
        if jshape.kind == "train":
            out["opt"] += 2 * nbytes(shape, np.float32, spec)
    if jshape.kind == "decode":
        batch = jax_specs.decode_input_specs(jcfg, jshape)
    else:
        batch = jax_specs.input_specs(jcfg, jshape)
    if jshape.kind != "train":
        mem = 0
        if jcfg.is_encdec:
            mem = jshape.seq_len if jshape.kind == "prefill" else jax_specs.ENC_MEM_LEN_DECODE
        jmodel = jax_build_model(jcfg)
        jc = jax.eval_shape(functools.partial(jmodel.init_caches, jshape.global_batch,
                                              jshape.seq_len, jnp.dtype(jcfg.dtype),
                                              mem_len=mem))
        for x, s in zip(jax.tree_util.tree_leaves(jc),
                        jax.tree_util.tree_leaves(jax_specs.cache_shardings(jc, jmesh))):
            out["caches"] += nbytes(x.shape, x.dtype, s.spec)
    for name, s in jax_specs.batch_shardings(batch, jmesh).items():
        out["batch"] += nbytes(batch[name].shape, batch[name].dtype, s.spec)
    out["total"] = sum(out.values())
    return out


@pytest.mark.parametrize("arch", jax_list_archs())
def test_dryrun_bytes_match_reference_specs(arch):
    for mesh_name, multi in (("single", False), ("multi", True)):
        mesh = make_production_mesh(multi_pod=multi)
        assert sharding.mesh_axis_sizes(mesh) == MESHES[mesh_name]
        for shape_name, _ in _jax_cells(arch):
            want = _ref_bytes(arch, shape_name, MESHES[mesh_name])
            rec = dryrun.size_cell(arch, shape_name, multi, steps=False)
            assert rec["per_device_bytes"] == want, (arch, shape_name, mesh_name)
            assert rec["chips"] == (512 if multi else 256)
            assert rec["flops_per_dev"] is None and rec["terms_s"]["collective"] is None


def test_kimi_k2_dryrun_cli_prints_every_cell(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "kimi-k2-1t-a32b", "--mesh", "single"])
    assert e.value.code == 0
    import json

    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["shape"] for r in recs] == list(shapes_for(get_config("kimi-k2-1t-a32b")))
    for r in recs:
        assert r["ok"] and r["chips"] == 256 and r["per_device_gb"] > 0
    # the experts alone: 61 x 384 x 3 x 2048 x 7168 bf16 over 256 devices
    params = _port_params("kimi-k2-1t-a32b")
    experts = sum(p.numel() for n, p in params.named_parameters() if ".we" in n)
    assert experts == 61 * 384 * 3 * 2048 * 7168
    assert recs[0]["per_device_bytes"]["params"] > experts * 2 // 256
