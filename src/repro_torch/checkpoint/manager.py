"""Async, preemption-safe checkpointing of the train state, with elastic restore.

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
(``dtypes``, a JSON string); restore rebuilds each leaf bit for bit.  It
reads the file's members with a few threads, each straight into its
array with its CRC checked (``np.load`` reads the same file).

``restore`` writes into the target state's own tensors, in place, and
returns it.

**Elastic restore.**  A state sharded over a live mesh
(:func:`shard_train_state`) holds a :class:`Placed` leaf where the
unsharded state holds a tensor: this rank's block of the leaf under its
spec (``distributed.sharding``; the parameters by their per-layer spec,
each AdamW moment by its leaf's spec over the reference's stacked shape).
``save`` gathers each leaf's full logical value (collectives over the
mesh, so every rank of it calls ``save``) and one rank, the mesh's
origin, writes the same file an unsharded save writes.  ``restore`` into a
sharded target reads the whole file on every rank and keeps each rank's
block by the target's spec, after a barrier over the mesh (the writer's
``wait`` first), so a run saved on one mesh resumes on another, or on
one device, bit for bit, as long as the logical shapes are unchanged.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import threading
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["CheckpointManager", "Placed", "shard_train_state", "state_leaves"]


@dataclasses.dataclass
class Placed:
    """One leaf of a sharded state: this rank's block of a logical tensor."""

    local: torch.Tensor  # this rank's block
    shape: tuple  # the leaf's logical shape, as saved
    view: tuple  # the shape the spec splits (a flat moment: its leaf's stacked shape)
    spec: tuple  # ``distributed.sharding`` spec over ``view``
    mesh: Any  # a live DeviceMesh

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    def full(self) -> torch.Tensor:
        """The whole logical tensor, gathered over the mesh (collective)."""
        from repro_torch.distributed.sharding import gather_block

        return gather_block(self.local, self.spec, self.mesh).reshape(self.shape)

    def load(self, full: torch.Tensor) -> None:
        """Keep this rank's block of ``full`` (the logical tensor)."""
        from repro_torch.distributed.sharding import local_block

        block = local_block(full.reshape(self.view), self.spec, self.mesh)
        with torch.no_grad():
            self.local.copy_(block.to(self.local.dtype))


def _place(t: torch.Tensor, view: tuple, spec: tuple, mesh) -> Placed:
    from repro_torch.distributed.sharding import local_block

    full = t.detach().reshape(view)
    block = local_block(full, spec, mesh)
    block = block.clone() if block.numel() < full.numel() else block
    return Placed(block, tuple(t.shape), tuple(view), tuple(spec), mesh)


def shard_train_state(state, mesh, *, fsdp: bool = True):
    """``state`` (a ``train.steps.TrainState`` on this rank, the same on
    every rank) as this rank's blocks over a live ``mesh``: the parameters
    as a list of :class:`Placed` in ``named_parameters`` order by their
    per-layer spec, each float32 AdamW moment by its leaf's spec over the
    leaf's stacked shape (``launch.specs.state_specs``); 8-bit moments,
    the residuals and the step stay whole on every rank."""
    from repro_torch.distributed.sharding import leaf_specs
    from repro_torch.optim.adamw import Q8

    specs = leaf_specs(state.params, mesh, fsdp=fsdp)
    by_name = {n: ls.layer_spec for ls in specs for n in ls.names}
    params = [_place(p, tuple(p.shape), by_name[n], mesh)
              for n, p in state.params.named_parameters()]

    def moments(ms):
        return [m if isinstance(m, Q8) else _place(m, ls.shape, ls.spec if ls.shape else (),
                                                   mesh)
                for ls, m in zip(specs, ms)]

    opt = state.opt._replace(mu=moments(state.opt.mu), nu=moments(state.opt.nu))
    return state._replace(params=params, opt=opt)


def _origin(leaves: list) -> tuple:
    """(the mesh of the first Placed leaf or None, whether this rank writes)."""
    mesh = next((x.mesh for x in leaves if isinstance(x, Placed)), None)
    if mesh is None:
        return None, True
    return mesh, all(c == 0 for c in mesh.get_coordinate())


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` has reached this point (a reduce over each of
    its dimensions in turn links every rank to every other)."""
    for name in mesh.mesh_dim_names:
        if mesh.size(mesh.mesh_dim_names.index(name)) > 1:
            flag = torch.ones((1,), device=mesh.device_type)
            torch.distributed.all_reduce(flag, group=mesh.get_group(name))


def state_leaves(state: Any) -> list:
    """The tensors of ``state`` in checkpoint order (see the module's note);
    a :class:`Placed` leaf stands for its logical tensor."""
    if torch.is_tensor(state) or isinstance(state, Placed):
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


def _read_member(path: str, info: zipfile.ZipInfo) -> np.ndarray:
    """One stored ``.npy`` member of the checkpoint, read straight into its
    array through a file handle of its own, its CRC checked."""
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"checkpoint member {info.filename} is compressed")
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)  # the local file header; the data follows its name and extra
        name_len, extra_len = int.from_bytes(local[26:28], "little"), int.from_bytes(
            local[28:30], "little")
        start = info.header_offset + 30 + name_len + extra_len
        f.seek(start)
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        header_len = f.tell() - start
        count = int(np.prod(shape, dtype=np.int64))
        arr = np.empty(count, dtype=dtype)
        raw = arr.view(np.uint8)
        if header_len + raw.size != info.file_size or f.readinto(raw) != raw.size:
            raise ValueError(f"checkpoint member {info.filename}: size does not match")
        f.seek(start)
        crc = zlib.crc32(raw, zlib.crc32(f.read(header_len)))
    if crc != info.CRC:
        raise ValueError(f"checkpoint member {info.filename}: CRC mismatch")
    return arr.reshape(shape, order="F" if fortran else "C")


def _read_leaves(path: str) -> tuple:
    """(dtypes, leaves) of a checkpoint file (``np.load`` reads it too),
    its members read by a few threads at once, each into its array with
    one copy; the reads and CRC checks release the GIL."""
    with zipfile.ZipFile(path) as zf:
        infos = {i.filename: i for i in zf.infolist()}
    dtypes = json.loads(str(_read_member(path, infos["dtypes.npy"])))
    workers = min(8, os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        host = list(pool.map(lambda i: _read_member(path, infos[f"leaf_{i}.npy"]),
                             range(len(dtypes))))
    return dtypes, host


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
        """Write ``state`` as step ``step``; a sharded state is gathered first
        (every rank of its mesh calls this) and its origin rank writes."""
        leaves = state_leaves(state)
        _, writes = _origin(leaves)
        full = [x.full() if isinstance(x, Placed) else x for x in leaves]
        if not writes:
            return
        host = [_host(t) for t in full]  # device->host copy, sync

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
        """Load the checkpoint into ``target_like``'s tensors in place (a
        sharded target keeps each rank's block); returns ``(target_like,
        step)``."""
        self.wait()
        targets = state_leaves(target_like)
        mesh, _ = _origin(targets)
        if mesh is not None:
            _barrier(mesh)  # the writer's save has landed
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        dtypes, host = _read_leaves(self._path(step))
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
                if isinstance(tgt, Placed):
                    tgt.load(_tensor(arr, dtype))
                else:
                    tgt.copy_(_tensor(arr, dtype).to(tgt.dtype))
        return target_like, step
