"""Data-parallel serving and the elastic checkpoint over two gloo ranks on the CPU.

One process group of two ranks (spawned processes, a ``FileStore`` in a
temporary directory) runs every check of this topology once; the tests
read its results.  Beside it, two more processes run the serve CLI with
``--data-parallel`` under a torchrun-style environment.

- **Serving.**  qwen3-0.6b ``.reduced()`` serves the same queue in a pool
  of 4 with ``mesh=None`` and over a two-rank ``("data",)`` mesh (each
  rank owning 2 rows) at ``exact``, ``balanced``, ``draft``,
  ``balanced`` with ``attn_impl="pallas"`` (the approximate attention's
  q, k and v absmax made global) and self-speculatively: the token
  streams must be equal on both ranks.
- **The engine.**  Every mode's GEMM of each rank's rows, under the mesh,
  equals the rows of the unsharded GEMM: bit-equal for the integer-exact
  modes (``bitexact``, ``seqmul``, the packed GEMM of ``inject`` with its
  noise drawn globally) and for the float ones on the CPU (``exact``,
  ``lowrank``, ``fakequant``: the CPU's float32 GEMM gives each row the
  same bits whatever M is, which this checks).
- **Logits.**  The full model's logits of each rank's rows against the
  unsharded forward, at ``exact`` and ``balanced``: bit-equal on the CPU
  (the float GEMMs are the only M-dependent step, see above).
- **The elastic checkpoint.**  A reduced train state, one step in, sharded
  over a (data 2, model 1) mesh by its specs, saved async from two ranks
  (one writes), restored in the group onto the same mesh, and, in this
  test process, onto one device: bit-equal to an unsharded save of the
  same state.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 2
TIERS = ("exact", "balanced", "draft", "pallas-balanced", "speculative")
MODES = ("exact", "bitexact", "seqmul", "lowrank", "inject", "fakequant")
PROMPT, GEN, BATCH, REQUESTS = 8, 4, 4, 6
TIMEOUT_S = 240


def _env(**extra) -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1", **extra}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _finish(procs: list, what: str) -> list:
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, f"{what}: rc {p.returncode}\n{err[-4000:]}"
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("two_ranks")
    port = _free_port()
    cli = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-0.6b", "--reduced",
         "--device", "cpu", "--data-parallel", "--requests", "4", "--batch", "2", "--gen", "4"],
        env=_env(WORLD_SIZE=str(WORLD), RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    workers = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(out)], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    _finish(workers, "ranks")
    cli_out = _finish(cli, "serve --data-parallel")
    ranks = [pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    return dict(ranks=ranks, cli=cli_out, out=out)


@pytest.mark.parametrize("tier", TIERS)
def test_two_rank_serving_equals_the_unsharded_pool(group, tier):
    for res in group["ranks"]:
        plain, sharded, devices, leaks = res[f"serve/{tier}"]
        assert devices == WORLD and leaks == 0
        assert sorted(plain) == sorted(sharded) and len(plain) == REQUESTS
        for rid in plain:
            np.testing.assert_array_equal(plain[rid], sharded[rid], err_msg=f"{tier} {rid}")
    if tier == "speculative":
        assert group["ranks"][0]["serve/speculative/proposed"] > 0


@pytest.mark.parametrize("mode", MODES)
def test_two_rank_engine_gemm_equals_the_rows_of_the_unsharded_gemm(group, mode):
    for res in group["ranks"]:
        equal, diff = res[f"gemm/{mode}"]
        assert equal, (mode, diff)


@pytest.mark.parametrize("tier", ("exact", "balanced"))
def test_two_rank_logits_equal_the_unsharded_forward(group, tier):
    for res in group["ranks"]:
        equal, diff, scale = res[f"logits/{tier}"]
        assert equal, (tier, diff, scale)


def test_data_parallel_cli_prints_one_served_line(group):
    rank0, rank1 = group["cli"]
    assert re.search(r"served 4 requests, 16 tokens", rank0), rank0
    assert rank1.strip() == "", rank1


def test_elastic_restore_in_the_two_rank_group(group):
    for res in group["ranks"]:
        assert res["ckpt/restore-2"] == (True, res["ckpt/n_leaves"])


def test_elastic_save_from_two_ranks_restores_at_one(group):
    from repro_torch.checkpoint.manager import CheckpointManager, state_leaves

    state_a, state_b = _train_state(seed=5), _train_state(seed=6)
    sharded = CheckpointManager(str(group["out"] / "ckpt_sharded"))
    plain = CheckpointManager(str(group["out"] / "ckpt_plain"))
    got, step = sharded.restore(state_a)
    want, _ = plain.restore(state_b)
    assert step == 1
    for x, y in zip(state_leaves(got), state_leaves(want)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # the two files hold the same leaves, bit for bit
    a = np.load(group["out"] / "ckpt_sharded" / "step_00000001.npz")
    b = np.load(group["out"] / "ckpt_plain" / "step_00000001.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 10
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name])


# --------------------------------------------------------------- the ranks
def _train_state(seed: int, steps: int = 0):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = get_config("qwen3-0.6b").reduced(num_layers=2, d_model=32, d_ff=64, vocab_size=64,
                                           num_heads=2, num_kv_heads=2, head_dim=8)
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=4, warmup_steps=1, learning_rate=1e-3)
    state = init_train_state(model, tcfg, seed, device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=4))
    step = make_train_step(model, tcfg)
    for i in range(steps):
        batch = {k: torch.from_numpy(v).long() for k, v in data.batch(i).items()}
        state, _ = step(state, batch)
    return state


def _serve_checks(mesh, res: dict) -> None:
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ContinuousScheduler, synth_requests

    cfg = get_config("qwen3-0.6b").reduced()
    params = build_model(cfg).init_params(0, device="cpu")
    queue = synth_requests(REQUESTS, prompt_len=PROMPT, gen=GEN, vocab_size=cfg.vocab_size,
                           seed=0)
    for tier in TIERS:
        model, kw = build_model(cfg), dict(quality=tier)
        if tier == "pallas-balanced":
            model = build_model(dataclasses.replace(cfg, attn_impl="pallas"))
            kw = dict(quality="balanced")
        elif tier == "speculative":
            kw = dict(strategy="speculative")
        runs = [ContinuousScheduler(model, params, batch_size=BATCH, prompt_len=PROMPT,
                                    max_new=GEN, mesh=m, **kw).run(queue, warmup=False)
                for m in (None, mesh)]
        res[f"serve/{tier}"] = (runs[0].outputs, runs[1].outputs, runs[1].stats.devices,
                                runs[1].accounting.slot_leaks)
        if tier == "speculative":
            res["serve/speculative/proposed"] = runs[1].stats.spec_proposed


def _gemm_and_logit_checks(mesh, rank: int, res: dict) -> None:
    from repro_torch import engine
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding
    from repro_torch.engine import config as engine_config
    from repro_torch.models.registry import build_model

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    x[4:] *= 3.0  # the second rank's rows hold the absmax
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    rows = slice(rank * 4, rank * 4 + 4)
    for mode in MODES:
        def call(a):
            gen = torch.Generator().manual_seed(0) if mode == "inject" else None
            return engine.matmul(a, w, n=8, t=4, mode=mode, generator=gen, backend="reference")

        want = call(x)
        with sharding.mesh_context(mesh):
            got = sharding.gather_rows(call(x[rows]))
        res[f"gemm/{mode}"] = (torch.equal(got, want), float((got - want).abs().max()))

    cfg = get_config("qwen3-0.6b").reduced()
    params = build_model(cfg).init_params(0, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)))
    pos = torch.arange(PROMPT)[None].expand(BATCH, PROMPT)
    half = slice(rank * BATCH // WORLD, (rank + 1) * BATCH // WORLD)
    for tier in ("exact", "balanced"):
        model = build_model(engine_config.apply_quality(cfg, engine_config.get_tier(tier)))

        def logits(t, p):
            hidden, _, _ = model.forward(params, t, p, model.ctx())
            return model.lm_head(params, hidden)

        with torch.inference_mode():
            want = logits(toks, pos)
            with sharding.mesh_context(mesh):
                got = sharding.gather_rows(logits(toks[half], pos[half]))
        res[f"logits/{tier}"] = (torch.equal(got, want), float((got - want).abs().max()),
                                 float(want.abs().max()))


def _checkpoint_checks(rank: int, out: pathlib.Path, res: dict) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.manager import (
        CheckpointManager, Placed, shard_train_state, state_leaves,
    )
    from repro_torch.distributed.sharding import local_block

    mesh = init_device_mesh("cpu", (WORLD, 1), mesh_dim_names=("data", "model"))
    state = _train_state(seed=0, steps=1)
    sharded = shard_train_state(state, mesh)
    mgr = CheckpointManager(str(out / "ckpt_sharded"))
    mgr.save(1, sharded)  # async: the writer joins in restore
    if rank == 0:
        CheckpointManager(str(out / "ckpt_plain")).save(1, state, blocking=True)
    target = shard_train_state(_train_state(seed=3), mesh)
    mgr.restore(target)
    ok = 0
    for got, full in zip(state_leaves(target), state_leaves(state)):
        if isinstance(got, Placed):
            ok += torch.equal(got.local, local_block(full.detach().reshape(got.view), got.spec,
                                                     mesh))
        else:
            ok += torch.equal(got, full)
    n = len(state_leaves(state))
    assert any(isinstance(x, Placed) and x.local.numel() < math_prod(x.shape)
               for x in state_leaves(target)), "nothing was split"
    res["ckpt/restore-2"] = (ok == n, n)
    res["ckpt/n_leaves"] = n


def math_prod(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _worker(rank: int, world: int, out: pathlib.Path) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    store = torch.distributed.FileStore(str(out / "store"), world)
    torch.distributed.init_process_group("gloo", store=store, rank=rank, world_size=world)
    res: dict = {}
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        _gemm_and_logit_checks(mesh, rank, res)
        _serve_checks(mesh, res)
        _checkpoint_checks(rank, out, res)
    finally:
        torch.distributed.destroy_process_group()
    (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3]))
