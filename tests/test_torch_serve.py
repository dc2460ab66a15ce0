"""The port's continuous scheduler and serve CLI, and its independence of JAX.

The scheduler of ``repro_torch`` serves the same ``synth_requests`` queue
as the JAX scheduler on the same (converted) weights in the exact pool:
the greedy token streams must be equal.  A greedy choice whose top-2
logit margin is below 1e-4 could legitimately go either way (the two
frameworks sum in another order), so the test records every margin the
port's pool sees and asserts that none is that small at this seed before
it asserts equality.
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.registry import get_config as jax_get_config
from repro.models.registry import build_model as jax_build_model
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import synth_requests as jax_synth_requests
from repro_torch.configs.registry import get_config
from repro_torch.models.registry import build_model, from_jax_params
from repro_torch.serve import ContinuousScheduler, Request, synth_requests

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROMPT, GEN, BATCH = 8, 4, 2
MARGIN = 1e-4


@pytest.fixture(scope="module")
def pools():
    jcfg, tcfg = jax_get_config("qwen3-0.6b").reduced(), get_config("qwen3-0.6b").reduced()
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, tmodel, tparams


def test_synth_requests_copy_draws_the_same_queue():
    kw = dict(prompt_len=PROMPT, gen=GEN, vocab_size=256, seed=3, eos_id=7, quality="draft")
    for a, b in zip(jax_synth_requests(9, **kw), synth_requests(9, **kw)):
        assert (a.id, a.max_new, a.eos_id, a.quality) == (b.id, b.max_new, b.eos_id, b.quality)
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_exact_pool_streams_match_the_jax_scheduler(pools):
    _check_exact_pool(*pools)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_exact_pool_streams_of_vl_and_moe_archs_match_the_jax_scheduler(arch):
    """Reduced qwen2-vl-7b (M-RoPE, the t-ids masking the padded admission),
    granite-moe-1b-a400m and kimi-k2-1t-a32b (experts at their own
    capacity over each admission and decode batch, kimi-k2's factor of 1.0
    dropping assignments)."""
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    _check_exact_pool(jmodel, jparams, tmodel, tparams)


def _check_exact_pool(jmodel, jparams, tmodel, tparams):
    queue = synth_requests(6, prompt_len=PROMPT, gen=GEN, vocab_size=256, seed=0)
    assert len({r.prompt_len for r in queue}) > 1 and len({r.max_new for r in queue}) > 1
    want = JaxScheduler(
        jmodel, jparams, batch_size=BATCH, prompt_len=PROMPT, max_new=GEN
    ).run(jax_synth_requests(6, prompt_len=PROMPT, gen=GEN, vocab_size=256, seed=0),
          warmup=False)

    margins = []
    lm_head = tparams.lm_head

    def recording_lm_head(hidden):
        logits = lm_head(hidden)
        top2 = torch.topk(logits[:, -1], 2, dim=-1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        return logits

    tparams.lm_head = recording_lm_head
    try:
        got = ContinuousScheduler(
            tmodel, tparams, batch_size=BATCH, prompt_len=PROMPT, max_new=GEN
        ).run(queue, warmup=False)
    finally:
        del tparams.lm_head
    assert min(margins) > MARGIN, "a greedy near-tie: the streams may differ legitimately"
    for r in queue:
        np.testing.assert_array_equal(got.outputs[r.id], want.outputs[r.id],
                                      err_msg=f"request {r.id}")
        assert len(got.outputs[r.id]) == r.max_new
    acc, jacc = got.accounting, want.accounting
    assert acc.slot_leaks == 0 and acc.position_violations == 0
    for field in ("seated", "retired", "pool_prefill_seats", "admission_seats", "max_live",
                  "slot_reuse"):
        assert getattr(acc, field) == getattr(jacc, field), field
    assert got.stats.decode_steps == want.stats.decode_steps
    assert got.stats.tokens_out == want.stats.tokens_out == sum(r.max_new for r in queue)


def test_served_steps_record_no_autograd_graph(pools):
    """The parameters are trainable (``requires_grad``); serving runs under
    ``torch.inference_mode()``, so no served step builds a graph."""
    _, _, tmodel, tparams = pools
    assert all(p.requires_grad for p in tparams.parameters())
    sched = ContinuousScheduler(tmodel, tparams, batch_size=BATCH, prompt_len=PROMPT,
                                max_new=GEN)
    eng = sched.engine_for(None)
    toks = torch.zeros((BATCH, PROMPT), dtype=torch.int64)
    pos = torch.arange(PROMPT).expand(BATCH, PROMPT)
    caches, tok = eng.prefill_pool(tparams, toks, pos)
    at = torch.full((BATCH,), PROMPT, dtype=torch.int64)
    nxt, caches = eng.decode(tparams, caches, tok[:, None], at, at)
    for t in (tok, nxt, *(x for c in caches for x in c)):
        assert t.grad_fn is None and not t.requires_grad and t.is_inference()
    result = sched.run(synth_requests(3, prompt_len=PROMPT, gen=GEN, vocab_size=256, seed=1))
    assert result.stats.requests == 3


def test_tier_pool_serves_its_tier_and_refuses_another(pools):
    _, _, tmodel, tparams = pools
    queue = synth_requests(3, prompt_len=PROMPT, gen=GEN, vocab_size=256, seed=1,
                           quality="balanced")
    sched = ContinuousScheduler(tmodel, tparams, batch_size=BATCH, prompt_len=PROMPT,
                                max_new=GEN, quality="balanced")
    assert sched.model.cfg.approx.mode == "bitexact"
    res = sched.run(queue, warmup=False)
    assert res.stats.quality == "balanced" and res.accounting.slot_leaks == 0
    assert {r.tier_served for r in res.request_stats} == {"balanced"}
    odd = Request(id=9, tokens=np.arange(5, dtype=np.int32), max_new=2, quality="draft")
    with pytest.raises(ValueError, match="demands quality tier 'draft'.*serves 'balanced'"):
        sched.run([odd], warmup=False)
    untagged_pool = ContinuousScheduler(tmodel, tparams, batch_size=BATCH, prompt_len=PROMPT,
                                        max_new=GEN)
    with pytest.raises(ValueError, match="built without one"):
        untagged_pool.run([odd], warmup=False)


def test_unported_serving_options_raise(pools):
    """A mesh that is no live DeviceMesh (an object, a mesh without a
    process group) raises rather than serving unsharded; unknown policy and
    strategy names raise ValueError listing the known ones."""
    _, _, tmodel, tparams = pools
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(ValueError, match="DeviceMesh over an initialized process group"):
        ContinuousScheduler(tmodel, tparams, batch_size=BATCH, prompt_len=PROMPT, max_new=GEN,
                            mesh=object())
    with pytest.raises(ValueError, match="has no process group"):
        ContinuousScheduler(tmodel, tparams, batch_size=BATCH, prompt_len=PROMPT, max_new=GEN,
                            mesh=make_production_mesh())
    sched = ContinuousScheduler(tmodel, tparams, batch_size=BATCH, prompt_len=PROMPT,
                                max_new=GEN)
    req = synth_requests(1, prompt_len=PROMPT, gen=GEN, vocab_size=256)
    with pytest.raises(ValueError, match=r"known: \['reject', 'slo-adaptive', 'static'\]"):
        sched.run(req, policy="adaptive", warmup=False)
    with pytest.raises(ValueError, match=r"known: \['greedy', 'speculative'\]"):
        ContinuousScheduler(tmodel, tparams, batch_size=1, prompt_len=PROMPT, max_new=GEN,
                            strategy="beam")


def test_scheduler_under_explicit_one_device_mesh(pools, tmp_path):
    """A one-rank ('data',) mesh must not change the streams (the
    reference's ``test_scheduler_under_explicit_mesh``), greedy and
    speculative; without a process group there is no data-parallel mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import data_parallel_mesh

    _, _, tmodel, tparams = pools
    assert not torch.distributed.is_initialized() and data_parallel_mesh(4) is None
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    torch.distributed.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        assert data_parallel_mesh(4, device="cpu") is None  # one rank: unsharded
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        queue = synth_requests(3, prompt_len=PROMPT, gen=GEN, vocab_size=256, seed=5)
        for strategy in ("greedy", "speculative"):
            kw = dict(batch_size=1, prompt_len=PROMPT, max_new=GEN, strategy=strategy)
            plain = ContinuousScheduler(tmodel, tparams, **kw).run(queue, warmup=False)
            sharded = ContinuousScheduler(tmodel, tparams, mesh=mesh, **kw).run(queue,
                                                                                  warmup=False)
            assert sharded.stats.devices == 1
            for r in queue:
                np.testing.assert_array_equal(plain.outputs[r.id], sharded.outputs[r.id])
    finally:
        torch.distributed.destroy_process_group()


def _run(*args, **kw):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=300, **kw)


def test_cpu_entry_point_serves():
    proc = _run("-m", "repro_torch.launch.serve", "--arch", "qwen3-0.6b", "--reduced",
                "--device", "cpu", "--requests", "4", "--batch", "2", "--gen", "4")
    assert proc.returncode == 0, proc.stderr
    assert re.search(r"served 4 requests, 16 tokens", proc.stdout), proc.stdout


def test_entry_point_without_gpu_or_cpu_flag_raises():
    from repro_torch.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    # --data-parallel in one process: no mesh, the pool served unsharded
    proc = _run("-m", "repro_torch.launch.serve", "--reduced", "--device", "cpu",
                "--data-parallel", "--requests", "2", "--batch", "2", "--gen", "2")
    assert proc.returncode == 0, proc.stderr
    assert re.search(r"served 2 requests, 4 tokens", proc.stdout), proc.stdout


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.launch.soak\n"
        "import repro_torch.launch.train\n"
        "import repro_torch.serve.workload\n"
        "import repro_torch.serve.soak\n"
        "import repro_torch.serve.policy\n"
        "import repro_torch.serve.strategy\n"
        "import repro_torch.core.error_metrics\n"
        "import repro_torch.kernels.seqmul_kernel\n"
        "import repro_torch.kernels.ops\n"
        "import repro_torch.examples.quickstart\n"
        "import repro_torch.examples.accuracy_sweep\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "or m == 'repro')\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = _run("-c", code)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_port_sources_name_no_jax_and_no_reference_module():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro(\.|\s|$)|from repro(\.|\s))",
                         re.MULTILINE)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
