"""Expert-parallel MoE and the elastic restore over four gloo ranks on the CPU.

One process group of four ranks (spawned processes, a ``FileStore`` in a
temporary directory) runs every check of this topology once; beside it a
JAX subprocess with 4 forced host devices runs the reference's
``_moe_sharded`` on the same inputs, as ``tests/test_distributed_integration.py``
does.  The tests read both.

- **(data 2, model 2).**  ``moe_ffn`` of each data rank's rows takes the
  port's ``_moe_sharded`` (two experts of granite's reduced eight per model
  rank, local capacity per data rank, the combine summed over the model
  ranks).  At ``capacity_factor`` 8 nothing is dropped and it equals the
  port's single-device path at the reference's tolerances (rtol 2e-4,
  atol 2e-5; aux within 1e-4); at 1.0 tokens are dropped and it equals the
  reference's ``_moe_sharded`` at the same tolerances.  Under ``bitexact``
  on the ``moe`` target it runs one engine GEMM per local expert on the
  expert's slots of this data rank, with the absmax global over the data
  ranks; at capacity factor 8 its output equals the single-device path's
  within the same tolerances (a per-rank absmax would move every scale).
- **(data 4).**  The data-only path of (c): each rank's rows are routed
  with every rank's tokens (capacity counted over all of them, 1.0 here so
  tokens drop), bit-equal to the rows of the single-device path.
- **``data_parallel_mesh``** takes the largest rank count that divides the
  batch; ranks past it are not part of the mesh.
- **The elastic restore at four.**  A reduced train state, sharded over a
  (data 2, model 1) mesh of ranks 0 and 1 and saved by them, is restored
  by all four ranks onto a (data 2, model 2) and a (data 4, model 1) mesh:
  every rank's block bit-equal to the same block of the saved state.
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
MOE = dict(num_experts=8, num_experts_per_tok=2, moe_d_ff=16, d_model=32)
TIMEOUT_S = 300

REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.distributed.sharding import make_auto_mesh, mesh_context
from repro.models import moe
from repro.models.layers import Ctx

z = np.load(sys.argv[1])
params = {k: jnp.asarray(z[k]) for k in ("router", "we1", "we3", "we2")}
x = jnp.asarray(z["x"])
out = {}
for cf in (1.0, 8.0):
    cfg = get_config("granite-moe-1b-a400m").reduced(
        num_experts=8, num_experts_per_tok=2, moe_d_ff=16, d_model=32, capacity_factor=cf)
    ctx = Ctx(cfg=cfg)
    o, a = moe.moe_ffn(params, x, ctx)
    out[f"local{cf}"], out[f"aux_local{cf}"] = np.asarray(o), np.asarray(a)
    mesh = make_auto_mesh((2, 2), ("data", "model"))
    with mesh_context(mesh):
        o, a = jax.jit(lambda p, v: moe.moe_ffn(p, v, ctx))(params, x)
    out[f"sharded{cf}"], out[f"aux_sharded{cf}"] = np.asarray(o), np.asarray(a)
np.savez(sys.argv[2], **out)
"""


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


def _inputs(path: pathlib.Path) -> None:
    rng = np.random.default_rng(0)
    e, d, f = MOE["num_experts"], MOE["d_model"], MOE["moe_d_ff"]

    def nrm(shape, s):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    np.savez(path, router=nrm((d, e), d**-0.5), we1=nrm((e, d, f), d**-0.5),
             we3=nrm((e, d, f), d**-0.5), we2=nrm((e, f, d), f**-0.5),
             x=nrm((4, 8, d), 1.0))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("four_ranks")
    _inputs(out / "moe_inputs.npz")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(out / "moe_inputs.npz"),
         str(out / "moe_reference.npz")], env={**_env(), "JAX_PLATFORMS": "cpu"}, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    workers = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(out)], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    for p in workers + [ref]:
        _, err = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, err[-4000:]
    ranks = [pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    return dict(ranks=ranks, ref=dict(np.load(out / "moe_reference.npz")))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_moe_sharded_equals_the_local_path_without_drops(group):
    for res in group["ranks"]:
        (out, aux), (out_l, aux_l) = res["moe/sharded8.0"], res["moe/local8.0"]
        assert res["moe/took_sharded"]
        _close(out, out_l)
        assert abs(aux - aux_l) < 1e-4


def test_moe_sharded_equals_the_reference_sharded_with_drops(group):
    ref = group["ref"]
    for res in group["ranks"]:
        out, aux = res["moe/sharded1.0"]
        _close(out, ref["sharded1.0"])
        assert abs(aux - float(ref["aux_sharded1.0"])) < 1e-4
        assert res["moe/dropped1.0"] > 0
        # and the local paths agree with each other
        _close(res["moe/local1.0"][0], ref["local1.0"])
    # the reference's own sharded run differs from its local one when tokens drop
    assert not np.allclose(ref["sharded1.0"], ref["local1.0"], rtol=2e-4, atol=2e-5)


def test_moe_sharded_engine_gemms_quantize_globally(group):
    for res in group["ranks"]:
        (out, aux), (out_l, aux_l) = res["moe/bitexact8.0"], res["moe/bitexact_local8.0"]
        _close(out, out_l)
        assert abs(aux - aux_l) < 1e-4


def test_moe_data_only_path_equals_the_global_path(group):
    for res in group["ranks"]:
        equal, aux_equal = res["moe/data-only1.0"]
        assert equal and aux_equal


def test_data_parallel_mesh_takes_the_largest_rank_count_that_divides(group):
    """Batch 6 over four ranks: a mesh of three, the fourth sits out;
    batch 8: all four; batch 1: no mesh."""
    coords = [res["dp-mesh"] for res in group["ranks"]]
    assert coords == [((0,), (0,), None), ((1,), (1,), None), ((2,), (2,), None),
                      (None, (3,), None)]


@pytest.mark.parametrize("shape", ["2x2", "4x1"])
def test_elastic_restore_from_two_ranks_at_four(group, shape):
    for res in group["ranks"]:
        ok, n, split = res[f"ckpt/restore-{shape}"]
        assert ok == n and split > 0


# --------------------------------------------------------------- the ranks
def _moe_checks(rank: int, out: pathlib.Path, res: dict) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.registry import apply_approx, get_config
    from repro_torch.distributed import sharding
    from repro_torch.models import moe
    from repro_torch.models.layers import Ctx

    z = np.load(out / "moe_inputs.npz")
    params = {k: torch.from_numpy(z[k]) for k in ("router", "we1", "we3", "we2")}
    x = torch.from_numpy(z["x"])
    ep = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    dp = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
    d_idx = ep.get_local_rank("data")
    with torch.inference_mode():
        for cf in (1.0, 8.0):
            cfg = get_config("granite-moe-1b-a400m").reduced(**MOE, capacity_factor=cf)
            for label, c in (("", cfg),
                             ("bitexact", apply_approx(cfg, mode="bitexact",
                                                       targets=("moe",)))):
                ctx = Ctx(cfg=c)
                o, a = moe.moe_ffn(params, x, ctx)
                res[f"moe/{label or 'local'}{'_local' if label else ''}{cf}"] = (
                    o.numpy(), float(a))
                with sharding.mesh_context(ep):
                    o, a = moe.moe_ffn(params, x[2 * d_idx:2 * d_idx + 2], ctx)
                    res["moe/took_sharded"] = moe._sharded_applies(c, ep, x.shape[0] * 8)
                o = sharding.gather_rows(o, *sharding.data_group(ep)[::2])
                res[f"moe/{label or 'sharded'}{cf}"] = (o.numpy(), float(a))
            # how many assignments the global route drops at this factor
            r = moe.route(params["router"], x.reshape(-1, MOE["d_model"]), cfg)
            res[f"moe/dropped{cf}"] = int((~r.keep).sum())
            if cf == 1.0:  # (c) on a data-only mesh of four
                want, aux_want = moe.moe_ffn(params, x, Ctx(cfg=cfg))
                with sharding.mesh_context(dp):
                    got, aux = moe.moe_ffn(params, x[rank:rank + 1], Ctx(cfg=cfg))
                got = sharding.gather_rows(got, *sharding.data_group(dp)[::2])
                res["moe/data-only1.0"] = (torch.equal(got, want), torch.equal(aux, aux_want))


def _checkpoint_checks(rank: int, out: pathlib.Path, res: dict) -> None:
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from repro_torch.checkpoint.manager import (
        CheckpointManager, Placed, shard_train_state, state_leaves,
    )
    from repro_torch.distributed.sharding import local_block

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_distributed import _train_state

    state = _train_state(seed=0, steps=1)
    two = DeviceMesh("cpu", torch.arange(2)[:, None], mesh_dim_names=("data", "model"))
    mgr = CheckpointManager(str(out / "ckpt"))
    if two.get_coordinate() is not None:  # ranks 0 and 1 save; 2 and 3 sit out
        mgr.save(1, shard_train_state(state, two), blocking=True)
    for shape, dims in (("2x2", (2, 2)), ("4x1", (4, 1))):
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
        target = shard_train_state(_train_state(seed=3), mesh)
        CheckpointManager(str(out / "ckpt")).restore(target)
        ok = split = 0
        for got, full in zip(state_leaves(target), state_leaves(state)):
            if isinstance(got, Placed):
                want = local_block(full.detach().reshape(got.view), got.spec, mesh)
                ok += torch.equal(got.local, want)
                split += got.local.numel() < full.numel()
            else:
                ok += torch.equal(got, full)
        res[f"ckpt/restore-{shape}"] = (ok, len(state_leaves(state)), split)


def _worker(rank: int, world: int, out: pathlib.Path) -> None:
    torch.set_num_threads(1)
    store = torch.distributed.FileStore(str(out / "store"), world)
    torch.distributed.init_process_group("gloo", store=store, rank=rank, world_size=world)
    res: dict = {}
    try:
        from repro_torch.distributed.sharding import data_parallel_mesh

        meshes = [data_parallel_mesh(b, device="cpu") for b in (6, 8, 1)]
        res["dp-mesh"] = tuple(m if m is None else m.get_coordinate() for m in meshes)
        _moe_checks(rank, out, res)
        _checkpoint_checks(rank, out, res)
    finally:
        torch.distributed.destroy_process_group()
    (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3]))
