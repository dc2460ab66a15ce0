"""The port's checkpoint manager and fault-tolerant loop, on the CPU.

Counterparts of ``tests/test_checkpoint_fault.py``: a roundtrip (bit for
bit, bfloat16 parameters and 8-bit optimizer state included), pruning and
the async write, a structure mismatch, ``run_loop`` recovering from
injected failures to the parameters of an uninterrupted run (bit-equal:
counter-based data, checkpointed state, a deterministic CPU step), and the
straggler monitor.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.manager import CheckpointManager, state_leaves
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.registry import build_model
from repro_torch.runtime.fault import FailureInjector, StragglerMonitor, run_loop
from repro_torch.train.steps import init_train_state, make_train_step


def _setup(steps=12, compress=0, bits=32, dtype="float32", seed=0):
    cfg = get_config("qwen3-0.6b").reduced(num_layers=2, d_model=32, d_ff=64, vocab_size=64,
                                           num_heads=2, num_kv_heads=1, head_dim=8,
                                           dtype=dtype)
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=steps, warmup_steps=2, learning_rate=1e-3,
                       grad_compress_bits=compress, opt_state_bits=bits)
    state = init_train_state(model, tcfg, seed, device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))

    def batch_fn(i):
        return {k: torch.from_numpy(v).long() for k, v in data.batch(i).items()}

    return state, make_train_step(model, tcfg), batch_fn


def _assert_same(a, b):
    la, lb = state_leaves(a), state_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype,bits,compress", [("float32", 32, 8), ("bfloat16", 8, 0)],
                         ids=["f32-compress", "bf16-8bit"])
def test_checkpoint_roundtrip_bit_exact(tmp_path, dtype, bits, compress):
    state, step, batch_fn = _setup(compress=compress, bits=bits, dtype=dtype)
    state1, _ = step(state, batch_fn(0))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, state1, blocking=True)
    assert mgr.latest_step() == 1
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["n_leaves"] == len(state_leaves(state1))
    if dtype == "bfloat16":
        assert "bfloat16" in manifest["dtypes"] and "int8" in manifest["dtypes"]
    target, _, _ = _setup(compress=compress, bits=bits, dtype=dtype, seed=5)
    target, at = mgr.restore(target)
    assert at == 1
    _assert_same(target, state1)


def test_checkpoint_prune_and_async(tmp_path):
    state, _, _ = _setup()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for i in range(5):
        mgr.save(i, state)  # async
    mgr.wait()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert len(files) <= 2
    assert mgr.latest_step() == 4


def test_async_save_is_a_snapshot(tmp_path):
    """An in-place update after ``save`` returns must not reach the file."""
    state, step, batch_fn = _setup()
    before = [t.detach().clone() for t in state_leaves(state)]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state)
    state, _ = step(state, batch_fn(0))  # updates the parameters in place
    mgr.wait()
    target, _, _ = _setup(seed=3)
    mgr.restore(target)
    for got, want in zip(state_leaves(target), before):
        assert torch.equal(got, want)


def test_restore_reads_np_load_s_file_and_catches_a_flipped_byte(tmp_path):
    """restore reads its members straight into their arrays: the leaves
    equal ``np.load``'s of the same file, and one flipped data byte fails
    the member's CRC check."""
    state, _, _ = _setup()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state, blocking=True)
    path = tmp_path / "step_00000000.npz"
    target, _, _ = _setup(seed=3)
    mgr.restore(target)
    with np.load(path) as z:
        for i, got in enumerate(state_leaves(target)):
            np.testing.assert_array_equal(got.detach().numpy(), z[f"leaf_{i}"])
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC mismatch"):
        mgr.restore(target)


def test_checkpoint_structure_mismatch(tmp_path):
    state, _, _ = _setup()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"a": torch.zeros(3)}, blocking=True)
    with pytest.raises(ValueError, match="structure"):
        mgr.restore(state)
    mgr.save(1, [torch.zeros(3)], blocking=True)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore([torch.zeros(4)])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_run_loop_recovers_from_failures(tmp_path):
    """Injected failures + restore reproduce the no-failure run exactly."""
    steps = 12
    state, step, batch_fn = _setup(steps)
    clean = run_loop(state, step, batch_fn, total_steps=steps)
    state2, step2, _ = _setup(steps)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    faulty = run_loop(
        state2, step2, batch_fn, total_steps=steps, ckpt=mgr, checkpoint_every=4,
        injector=FailureInjector(fail_at=(5, 9)), max_failures=5,
    )
    assert faulty.failures == 2 and faulty.restarts >= 2
    assert int(faulty.state.step) == steps
    assert clean.metrics_history[-1]["loss"] == faulty.metrics_history[-1]["loss"]
    _assert_same(faulty.state, clean.state)
    # a new run resumes from the latest checkpoint
    state3, step3, _ = _setup(steps)
    resumed = run_loop(state3, step3, batch_fn, total_steps=steps, ckpt=mgr, checkpoint_every=4)
    assert resumed.restarts == 1 and not resumed.metrics_history  # already at the end
    _assert_same(resumed.state, clean.state)


def test_run_loop_exceeds_max_failures():
    state, step, batch_fn = _setup()
    with pytest.raises(RuntimeError, match="max_failures"):
        run_loop(state, step, batch_fn, total_steps=12,
                 injector=FailureInjector(fail_at=(2,)), max_failures=0)


def test_straggler_monitor():
    mon = StragglerMonitor(factor=3.0, warmup=2)
    for i in range(10):
        mon.record(i, 0.1)
    assert mon.record(10, 1.0)  # 10x EMA -> straggler
    assert mon.slow_steps and mon.slow_steps[0][0] == 10
    # EMA not polluted by the outlier
    assert mon.ema == pytest.approx(0.1, rel=0.05)
    assert np.isclose(mon.ema, 0.1)
