"""Every model family under a (data, model) mesh, over four gloo ranks on the CPU.

The sharded step and serving of the MoE (granite-moe-1b-a400m, kimi-k2
with sequence-sharded residuals), SSD (mamba2-130m), RG-LRU
(recurrentgemma-2b) and encoder-decoder (seamless-m4t-large-v2)
families, all ``.reduced()``, at exact float32 unless a check says
otherwise.  One process group of four ranks (spawned processes, a
``FileStore`` in a temporary directory) runs every check once, on meshes
1x1 (rank 0), 1x2 (ranks 0 and 1), 2x2 and 1x4 (data x model); beside it
one JAX subprocess with 4 forced host devices runs the reference's own
(2, 2) sharded train step for every family in one import, on the same
weights (the port's seeded init, in the reference's layout) and batches.

- **Train.**  Two ``grad_accum=2`` steps on each mesh against
  ``mesh=None`` (the MoE families at ``capacity_factor=8.0``, so that no
  token drops and the local capacity of the sharded path routes as the
  global one does, as ``tests/test_distributed_integration.py`` holds
  it) and on 2x2 against the reference's step (the default capacity: both
  route with the local capacity): losses within rtol 1e-5, parameters
  within atol 1e-6; on 1x1 the bits of ``mesh=None``; under ``bitexact``
  (mlp and attn) on 1x2 one step against ``mesh=None``.
- **Decode.**  A prefill and 3 decode steps on 1x2 and 2x2 against
  ``mesh=None``, logits within 2e-5 (seamless's cross cache split over
  its memory slots, the recurrent caches over heads and channels,
  kimi-k2's prefill over sequence-sharded residuals).
- **Serve.**  The continuous scheduler (granite, mamba2, recurrentgemma)
  and the static loop (every family here) on 2x2 give the unsharded
  streams at ``exact`` and ``balanced``.
- **The approximate attention at prefill under a model axis**
  (qwen3-0.6b, ``attn_impl="pallas"``, the ``attn`` target): the first
  layer's attention over a sequence-split cache equals ``mesh=None``'s,
  bit for bit under ``bitexact``, within rtol 2e-6 under ``lowrank``.
- **Counting.**  ``sharding.counting()`` sees the MoE's collectives (the
  combine's sum and the aux statistics' data mean, forward and backward).
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
TIMEOUT_S = 280
ACCUM, BATCH, SEQ = 2, 8, 16
FAMILIES = ("granite-moe-1b-a400m", "mamba2-130m", "recurrentgemma-2b",
            "seamless-m4t-large-v2", "kimi-k2-1t-a32b")
MOE = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b")
MESHES = ("1x2", "2x2", "1x4")

REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import TrainConfig
from repro.configs.registry import get_config
from repro.distributed.sharding import make_auto_mesh, mesh_context
from repro.launch import specs as S
from repro.models.registry import build_model
from repro.train.steps import init_train_state, make_train_step

z = np.load(sys.argv[1])
out = {}
mesh = make_auto_mesh((2, 2), ("data", "model"))
for arch in sys.argv[3].split(","):
    cfg = get_config(arch).reduced()
    if arch == "kimi-k2-1t-a32b":
        cfg = dataclasses.replace(cfg, seq_shard_residuals=True)
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=4, grad_accum=2)
    with mesh_context(mesh):
        state = init_train_state(model, tcfg, jax.random.PRNGKey(0))
        leaves, treedef = jax.tree_util.tree_flatten(state.params)
        params = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(z[f"{arch}/leaf{i}"]) for i in range(len(leaves))])
        state = state._replace(params=params)
        state_sh = S.state_shardings(jax.eval_shape(lambda: state), mesh)
        state = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, s) if hasattr(s, "spec") else x, state, state_sh)
        step = jax.jit(make_train_step(model, tcfg))
        for i in range(2):
            batch = {k: jnp.asarray(z[f"{arch}/{k}{i}"]) for k in ("tokens", "labels")}
            if cfg.is_encdec:
                batch["src_embeds"] = jnp.asarray(z[f"{arch}/src{i}"])
            state, metrics = step(state, batch)
            out[f"{arch}/loss{i}"] = np.asarray(metrics["loss"])
        for i, leaf in enumerate(jax.tree_util.tree_leaves(state.params)):
            out[f"{arch}/leaf{i}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


def _cfg(arch: str, **over):
    """The family's ``.reduced()`` config as this file runs it (kimi-k2
    with sequence-sharded residuals, as the dry-run sizes it)."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    cfg = get_config(arch).reduced(**over)
    if arch == "kimi-k2-1t-a32b":
        cfg = dataclasses.replace(cfg, seq_shard_residuals=True)
    return cfg


def _inputs(out: pathlib.Path) -> None:
    """Each family's weights (the port's seeded init, in the reference's
    leaf order) and its two global batches."""
    from repro_torch.models.registry import STACKS, build_model, reference_leaves

    data = {}
    rng = np.random.default_rng(0)
    for arch in FAMILIES:
        cfg = _cfg(arch)
        params = build_model(cfg).init_params(0, device="cpu")
        named = dict(params.named_parameters())
        for i, leaf in enumerate(reference_leaves(params)):
            data[f"{arch}/leaf{i}"] = (
                np.stack([named[n].detach().numpy() for n in leaf.names])
                if leaf.path[0] in STACKS else named[leaf.names[0]].detach().numpy())
        for i in range(2):
            for key in ("tokens", "labels"):
                data[f"{arch}/{key}{i}"] = rng.integers(0, cfg.vocab_size,
                                                        (BATCH, SEQ)).astype(np.int32)
            if cfg.is_encdec:
                data[f"{arch}/src{i}"] = rng.standard_normal(
                    (BATCH, SEQ, cfg.d_model)).astype(np.float32)
    np.savez(out / "inputs.npz", **data)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("tensor_parallel_families")
    _inputs(out)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(out / "inputs.npz"),
         str(out / "reference.npz"), ",".join(FAMILIES)],
        env={**_env(), "JAX_PLATFORMS": "cpu"}, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    workers = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(out)], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    for p in workers + [ref]:
        _, err = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, err[-4000:]
    ranks = [pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    return dict(ranks=ranks, ref=dict(np.load(out / "reference.npz")))


def _mine(res: list, key: str):
    return [r[key] for r in res if key in r]


def _close(res: dict) -> None:
    np.testing.assert_allclose(res["loss"], res["loss_whole"], rtol=1e-5)
    for have, want in zip(res["params"], res["params_whole"]):
        np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_train_steps_match_unsharded(group, arch, mesh):
    got = _mine(group["ranks"], f"train/{arch}/{mesh}")
    assert len(got) == (2 if mesh == "1x2" else 4)
    for res in got:
        _close(res)


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_train_steps_match_the_reference_sharded_step(group, arch):
    ref = group["ref"]
    res = _mine(group["ranks"], f"train-ref/{arch}")[0]
    np.testing.assert_allclose(res["loss"], [float(ref[f"{arch}/loss0"]),
                                             float(ref[f"{arch}/loss1"])], rtol=1e-5)
    for i, have in enumerate(res["params"]):
        np.testing.assert_allclose(have, ref[f"{arch}/leaf{i}"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_rank_mesh_train_steps_are_the_unsharded_bits(group, arch):
    assert _mine(group["ranks"], f"train-1x1-bits/{arch}") == [True]


@pytest.mark.parametrize("arch", FAMILIES)
def test_bitexact_sharded_train_step_matches_unsharded(group, arch):
    got = _mine(group["ranks"], f"train-bitexact/{arch}")
    assert len(got) == 2
    for res in got:
        _close(res)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_over_sharded_caches_matches_unsharded(group, arch, mesh):
    got = _mine(group["ranks"], f"decode/{arch}/{mesh}")
    assert got
    for steps in got:
        assert len(steps) == 4  # the prefill and 3 decode steps
        for have, want in steps:
            np.testing.assert_allclose(have, want, rtol=2e-5, atol=2e-5)


# the continuous scheduler serves decoder-only stacks, as the reference's
SERVED = [(arch, loop) for arch in FAMILIES[:4] for loop in ("continuous", "static")
          if loop == "static" or arch != "seamless-m4t-large-v2"]


@pytest.mark.parametrize("tier", ["exact", "balanced"])
@pytest.mark.parametrize("arch,loop", SERVED)
def test_serving_on_a_data_model_mesh_gives_the_unsharded_streams(group, arch, loop, tier):
    got = _mine(group["ranks"], f"serve/{arch}/{loop}/{tier}")
    assert len(got) == WORLD
    for want, have in got:
        assert want.keys() == have.keys()
        for rid in want:
            assert np.array_equal(have[rid], want[rid]), rid


@pytest.mark.parametrize("mode", ["bitexact", "lowrank"])
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_approximate_attention_prefill_under_a_model_axis(group, mode, mesh):
    got = _mine(group["ranks"], f"approx-attn/{mode}/{mesh}")
    assert got
    for have, want in got:
        if mode == "bitexact":
            assert np.array_equal(have, want), np.abs(have - want).max()
        else:
            np.testing.assert_allclose(have, want, rtol=2e-6, atol=2e-6 * np.abs(want).max())


def test_counting_sees_the_moe_collectives(group):
    from repro_torch.distributed.sharding import RS_AS_ALL_REDUCE

    for fwd, both, combine in _mine(group["ranks"], "moe-counts"):
        assert fwd["all-reduce"] >= combine  # the combine's sum and the data means
        assert both["all-reduce"] > fwd["all-reduce"]  # the backward's: copy_to, data mean
        assert both[RS_AS_ALL_REDUCE] > 0  # the experts' FSDP gathers, reduce-scattered


# --------------------------------------------------------------- the ranks
def _np(t):
    return t.detach().to(torch.float32).numpy().copy()


def _batch(inputs: dict, arch: str, i: int) -> dict:
    batch = {k: torch.from_numpy(inputs[f"{arch}/{k}{i}"]).long() for k in ("tokens", "labels")}
    if f"{arch}/src{i}" in inputs:
        batch["src_embeds"] = torch.from_numpy(inputs[f"{arch}/src{i}"])
    return batch


def _loaded(arch: str, cfg, inputs: dict):
    """The inputs' weights of ``arch`` in a module of ``cfg``."""
    from repro_torch.models.registry import STACKS, build_model, from_jax_params, \
        reference_leaves, to_jax_layout

    meta = build_model(cfg).init_params(0, device="meta")
    named = {}
    for i, leaf in enumerate(reference_leaves(meta)):
        arr = inputs[f"{arch}/leaf{i}"]
        for j, n in enumerate(leaf.names):
            named[n] = arr[j] if leaf.path[0] in STACKS else arr
    return from_jax_params(to_jax_layout(named, meta), cfg, device="cpu")


def _train(arch: str, cfg, mesh, inputs: dict, steps: int = 2):
    """(losses, params by name (whole), params in the reference's leaf
    order) after ``steps`` steps from the inputs' weights."""
    from repro_torch.checkpoint.manager import shard_train_state
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding
    from repro_torch.models.registry import STACKS, build_model, reference_leaves
    from repro_torch.train.steps import init_train_state, make_train_step, shard_batch

    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=4, grad_accum=ACCUM)
    state = init_train_state(model, tcfg, 0, device="cpu")
    with torch.no_grad():
        for p, q in zip(state.params.parameters(), _loaded(arch, cfg, inputs).parameters()):
            p.copy_(q)
    if mesh is not None:
        state = shard_train_state(state, mesh)
    step = make_train_step(model, tcfg, mesh=mesh)
    losses = []
    for i in range(steps):
        batch = _batch(inputs, arch, i)
        if mesh is not None:
            batch = shard_batch(batch, mesh, ACCUM)
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    meta = model.init_params(0, device="meta")
    names = [n for n, _ in meta.named_parameters()]
    if mesh is None:
        params = {n: _np(p) for n, p in state.params.named_parameters()}
    else:
        params = {n: _np(sharding.gather_block(p.local, p.spec, mesh))
                  for n, p in zip(names, state.params)}
    ref_order = [np.stack([params[n] for n in leaf.names]) if leaf.path[0] in STACKS
                 else params[leaf.names[0]] for leaf in reference_leaves(meta)]
    return losses, params, ref_order


def _item(got, whole) -> dict:
    names = list(whole[1])
    return dict(loss=got[0], loss_whole=whole[0], params=[got[1][n] for n in names],
                params_whole=[whole[1][n] for n in names])


def _train_checks(meshes: dict, inputs: dict, res: dict) -> None:
    from repro_torch.configs.registry import apply_approx

    for arch in FAMILIES:
        cfg = _cfg(arch, **({"capacity_factor": 8.0} if arch in MOE else {}))
        whole = _train(arch, cfg, None, inputs)
        runs = {}
        for label in MESHES:
            if meshes[label].get_coordinate() is not None:
                runs[label] = _train(arch, cfg, meshes[label], inputs)
                res[f"train/{arch}/{label}"] = _item(runs[label], whole)
        if meshes["1x1"].get_coordinate() is not None:
            got = _train(arch, cfg, meshes["1x1"], inputs)
            res[f"train-1x1-bits/{arch}"] = got[0] == whole[0] and all(
                np.array_equal(got[1][n], a) for n, a in whole[1].items())
        # against the reference at its own capacity: the local one on both sides
        got = _train(arch, _cfg(arch), meshes["2x2"], inputs) if arch in MOE else runs["2x2"]
        res[f"train-ref/{arch}"] = dict(loss=got[0], params=got[2])
        approx = apply_approx(cfg, mode="bitexact", n=8, t=4, targets=("mlp", "attn"))
        if meshes["1x2"].get_coordinate() is not None:
            res[f"train-bitexact/{arch}"] = _item(
                _train(arch, approx, meshes["1x2"], inputs, 1),
                _train(arch, approx, None, inputs, 1))


def _decode_checks(meshes: dict, res: dict) -> None:
    from repro_torch.distributed import sharding
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    rng = np.random.default_rng(4)
    b, prompt, max_seq = 4, 8, 16
    for arch in FAMILIES:
        cfg = _cfg(arch, **({"capacity_factor": 8.0} if arch in MOE else {}))
        model = build_model(cfg)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, prompt)))
        src = torch.from_numpy(rng.standard_normal((b, prompt, cfg.d_model)).astype(np.float32))
        mem = prompt if cfg.is_encdec else 0
        prefill, decode = make_prefill_step(model, max_seq, mem_len=mem), make_decode_step(model)

        def run(params, rows):
            batch = {"tokens": tokens[rows]}
            if cfg.is_encdec:
                batch["src_embeds"] = src[rows]
                batch["src_pos"] = torch.arange(prompt)[None].expand(batch["tokens"].shape[0],
                                                                     prompt)
            caches, logits = prefill(params, batch)
            outs = [logits]
            tok = torch.from_numpy(np.arange(b)[rows, None] % 7 + 3)
            for i in range(3):
                logits, caches = decode(params, caches, tok, prompt + i)
                outs.append(logits)
            return outs

        with torch.no_grad():
            want = run(model.init_params(0, device="cpu"), slice(0, b))
            for label in ("1x2", "2x2"):
                mesh = meshes[label]
                if mesh.get_coordinate() is None:
                    continue
                d = sharding.mesh_axis(mesh, "data")
                rows = slice(d.index * b // d.size, (d.index + 1) * b // d.size)
                with sharding.mesh_context(mesh):
                    got = run(model.init_params(0, device="cpu", mesh=mesh), rows)
                res[f"decode/{arch}/{label}"] = [(_np(g), _np(w[rows]))
                                                 for g, w in zip(got, want)]


def _serve_checks(mesh, res: dict) -> None:
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ContinuousScheduler, static_serve_loop, synth_requests

    for arch in FAMILIES[:4]:
        cfg = _cfg(arch, **({"capacity_factor": 8.0} if arch in MOE else {}))
        model = build_model(cfg)
        queue = synth_requests(6, prompt_len=8, gen=4, vocab_size=cfg.vocab_size, seed=0,
                               min_prompt=8)
        for tier in ("exact", "balanced"):
            if not cfg.is_encdec:
                runs = [ContinuousScheduler(model, model.init_params(0, device="cpu", mesh=m),
                                            batch_size=4, prompt_len=8, max_new=4, mesh=m,
                                            quality=tier).run(queue, warmup=False)
                        for m in (None, mesh)]
                res[f"serve/{arch}/continuous/{tier}"] = (runs[0].outputs, runs[1].outputs)
            runs = [static_serve_loop(model, model.init_params(0, device="cpu", mesh=m), queue,
                                      batch_size=4, prompt_len=8, gen=4, warmup=False,
                                      quality=tier, mesh=m) for m in (None, mesh)]
            res[f"serve/{arch}/static/{tier}"] = (runs[0].outputs, runs[1].outputs)


def _approx_attention_checks(meshes: dict, res: dict) -> None:
    import dataclasses

    from repro_torch.configs.registry import apply_approx, get_config
    from repro_torch.distributed import sharding
    from repro_torch.models import attention
    from repro_torch.models.registry import build_model
    from repro_torch.models.layers import Ctx

    rng = np.random.default_rng(5)
    b, s, t = 4, 8, 16
    base = dataclasses.replace(get_config("qwen3-0.6b").reduced(), attn_impl="pallas")
    x = torch.from_numpy(rng.standard_normal((b, s, base.d_model)).astype(np.float32))
    pos = torch.arange(s)[None].expand(b, s)
    for mode in ("bitexact", "lowrank"):
        cfg = apply_approx(base, mode=mode, n=8, t=4, targets=("attn",))
        model = build_model(cfg)

        def run(params, rows, ax=None):
            kv = attention.init_kv_cache(cfg, rows.stop - rows.start,
                                         t if ax is None else t // ax.size, torch.float32, "cpu")
            return attention.attention(params.layers[0].attn, x[rows], pos[rows],
                                       Ctx(cfg=cfg), cache=kv, cache_pos=0)[0]

        with torch.no_grad():
            want = run(model.init_params(0, device="cpu"), slice(0, b))
            for label in ("1x2", "2x2"):
                mesh = meshes[label]
                if mesh.get_coordinate() is None:
                    continue
                d = sharding.mesh_axis(mesh, "data")
                rows = slice(d.index * b // d.size, (d.index + 1) * b // d.size)
                with sharding.mesh_context(mesh):
                    got = run(model.init_params(0, device="cpu", mesh=mesh), rows,
                              sharding.model_axis(mesh))
                res[f"approx-attn/{mode}/{label}"] = (_np(got), _np(want[rows]))


def _count_checks(mesh, res: dict) -> None:
    from repro_torch.distributed import sharding
    from repro_torch.models import moe
    from repro_torch.models.layers import Ctx
    from repro_torch.models.registry import build_model

    cfg = _cfg("granite-moe-1b-a400m")
    params = build_model(cfg).init_params(0, device="cpu", mesh=mesh)
    ffn = params.layers[0].ffn_moe
    x = torch.randn((2, SEQ, cfg.d_model), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    with sharding.mesh_context(mesh):
        with sharding.counting() as fwd:
            out, aux = moe.moe_ffn(ffn, x, Ctx(cfg=cfg))
        with sharding.counting() as both:
            out, aux = moe.moe_ffn(ffn, x, Ctx(cfg=cfg))
            (out.sum() + aux).backward()
    res["moe-counts"] = (dict(fwd), dict(both), 2 * SEQ * cfg.d_model * 4)


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
        inputs = dict(np.load(out / "inputs.npz"))
        _count_checks(meshes["2x2"], res)
        _approx_attention_checks(meshes, res)
        _decode_checks(meshes, res)
        _serve_checks(meshes["2x2"], res)
        _train_checks(meshes, inputs, res)
    finally:
        torch.distributed.destroy_process_group()
    (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3]))
