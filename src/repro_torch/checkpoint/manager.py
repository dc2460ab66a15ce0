"""Async, preemption-safe checkpointing of the train state.

Counterpart of ``repro/checkpoint/manager.py``, with the same format: one
``step_<k>.npz`` per save holding the state's leaves as ``leaf_<i>``, and
a small JSON manifest naming the latest complete step.  Writes go to a
temporary file first and are renamed atomically, so a preemption
mid-write never corrupts the latest checkpoint; saves run on a background
thread (``wait()`` joins), so the training loop is not blocked on disk.

The leaves of a state are its tensors in a fixed order
(:func:`state_leaves`): the parameters of a module in ``named_parameters``
order, the fields of a tuple (an ``OptState``, a ``Q8``'s codes and
scales, the compression residuals, the step) in order, a dict's values by
sorted key; plain Python values (the run's seed) are not saved.  ``np.savez``
has no bfloat16, so a bfloat16 leaf is saved as its raw uint16 bits, and
every leaf's dtype is recorded, in the manifest and in the file itself
(``dtypes``, a JSON string); restore rebuilds each leaf bit for bit.

``restore`` writes into the target state's own tensors, in place, and
returns it: the port's state lives on one device, so the reference's
elastic re-sharding onto another mesh has no counterpart here.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["CheckpointManager", "state_leaves"]


def state_leaves(state: Any) -> list:
    """The tensors of ``state`` in checkpoint order (see the module's note)."""
    if torch.is_tensor(state):
        return [state]
    if isinstance(state, nn.Module):
        return [p for _, p in state.named_parameters()]
    if isinstance(state, (tuple, list)):
        return [leaf for item in state for leaf in state_leaves(item)]
    if isinstance(state, dict):
        return [leaf for k in sorted(state) for leaf in state_leaves(state[k])]
    return []  # None and plain Python values are static, not saved


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` that later in-place updates cannot reach."""
    t = t.detach().to("cpu", copy=True)
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), dtype
    return t.numpy(), dtype


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr).to(getattr(torch, dtype))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------- paths
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.npz")

    def _manifest(self) -> str:
        return os.path.join(self.directory, "manifest.json")

    def latest_step(self) -> Optional[int]:
        try:
            with open(self._manifest()) as f:
                return json.load(f)["step"]
        except (FileNotFoundError, json.JSONDecodeError, KeyError):
            return None

    # -------------------------------------------------------------- save
    def save(self, step: int, state: Any, *, blocking: bool = False) -> None:
        host = [_host(t) for t in state_leaves(state)]  # device->host copy, sync

        def write():
            # NB: np.savez appends ".npz" unless the name already ends in it
            tmp = self._path(step)[: -len(".npz")] + ".tmp.npz"
            dtypes = [d for _, d in host]
            np.savez(tmp, dtypes=np.array(json.dumps(dtypes)),
                     **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
            os.replace(tmp, self._path(step))
            mtmp = self._manifest() + ".tmp"
            with open(mtmp, "w") as f:
                json.dump({"step": step, "n_leaves": len(host), "dtypes": dtypes}, f)
            os.replace(mtmp, self._manifest())
            self._prune()

        def write_recording_errors():
            try:
                write()
            except Exception as e:  # noqa: BLE001 — re-raised by wait() in the caller's thread
                self._error = e

        self.wait()
        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write_recording_errors, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the background write; raise what it raised, if anything."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write failed: {err}") from err

    def _prune(self) -> None:
        ckpts = sorted(
            f for f in os.listdir(self.directory)
            if f.startswith("step_") and f.endswith(".npz") and ".tmp" not in f
        )
        for f in ckpts[: -self.keep] if self.keep else []:
            try:
                os.remove(os.path.join(self.directory, f))
            except OSError:
                pass

    # ------------------------------------------------------------ restore
    def restore(self, target_like: Any, step: Optional[int] = None) -> tuple[Any, int]:
        """Load the checkpoint into ``target_like``'s tensors in place;
        returns ``(target_like, step)``."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        with np.load(self._path(step)) as z:
            dtypes = json.loads(str(z["dtypes"]))
            host = [z[f"leaf_{i}"] for i in range(len(dtypes))]
        targets = state_leaves(target_like)
        if len(targets) != len(host):
            raise ValueError(
                f"checkpoint has {len(host)} leaves, target {len(targets)} — "
                "structure changed since save"
            )
        for tgt, arr in zip(targets, host):
            if tuple(tgt.shape) != tuple(arr.shape):
                raise ValueError(f"shape mismatch {tuple(tgt.shape)} vs {arr.shape}")
        with torch.no_grad():
            for tgt, arr, dtype in zip(targets, host, dtypes):
                tgt.copy_(_tensor(arr, dtype).to(tgt.dtype))
        return target_like, step
