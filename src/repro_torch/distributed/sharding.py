"""Sharding rules for parameters, batches and caches, and the mesh the port runs under.

Counterpart of ``repro/distributed/sharding.py``, with its own copy of the
rules.  Conventions, as the reference's:

  mesh axes   ("pod", "data", "model") multi-pod / ("data", "model") pod
  DP          batch over ("pod", "data")
  TP          heads / d_ff / vocab / experts over "model"
  FSDP        the largest remaining parameter dimension over "data"

A **spec** is a tuple of axis entries, one per dimension (``None``, an
axis name, or a tuple of axis names): the counterpart of a
``PartitionSpec``, entry for entry.  Every rule degrades as the
reference's does: an axis is kept only where the dimension divides by its
extent (``_resolve_entry``), and a spec of ``()`` replicates.

**Meshes.**  A live mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over an initialized process group, one rank per device; an
:class:`AbstractMesh` has axis names and sizes and no process group (the
production meshes of ``launch/mesh.py``, which the dry-run sizes).
:func:`mesh_context` installs a mesh for the code below it, as the
reference's ``mesh_context`` does around a trace.

**The contract.**  Every rank runs the same program on its own rows, and
a sharded run computes what one device computes.  Three places couple the
rows of a batch, and inside a live mesh context whose data group has more
than one rank each is made global with a collective:

(a) the per-tensor absmax of an activation (``quantize_operands``, the
    ``fakequant`` body, the approximate attention's q, k and v):
    :func:`global_max`, an all-reduce MAX over the data group;
(b) the ``inject`` surrogate's noise: each rank draws the global
    (M_global, N) noise from the one generator and keeps its own rows
    (:func:`global_rows`);
(c) MoE routing (``models/moe.py``): on a data-only mesh the tokens are
    gathered (:func:`gather_rows`) and routed globally, as the
    reference's global path does; on a (data, model) mesh the experts
    split over the model axis (``_moe_sharded``).

Where the rows are not sharded (the single-row admission prefill
``(1, P)``, which no data axis divides), the computation runs under
:func:`rows_replicated` and every rank computes the replicated value.

**Stacked leaves.**  The reference stacks the layers of a scanned group on
a leading axis; the port keeps one tensor per layer.  :func:`leaf_specs`
applies the rules to the reference's paths and stacked shapes
(``models.registry.reference_leaves``) and :attr:`LeafSpec.layer_spec`
drops the stacked entry for the port's per-layer tensors.  At the
production meshes (16, 16) and (2, 16, 16) no parameter leaf of any
registered arch gets an axis on its stacked dimension (the default FSDP
rule could pick it; it never does there).  Four cache leaves do, at
(2, 16, 16) only: recurrentgemma-2b's ``scan/sub0`` and ``scan/sub1``
``conv`` and ``h`` and mamba2-130m's ``scan/sub0/conv``, whose 8 and 24
stacked layers take ``pod`` (``launch/specs.py``: the reference's cache
rule puts DP on the leading dimension of a 4-d stacked tensor).  The
port's per-layer tensor of such a leaf is replicated over that axis (the
entry is dropped); the dry-run counts bytes on the reference's stacked
layout, so for these leaves the port's own placement holds twice the
dry-run's figure (under 2 MB a device for either model).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Optional

import torch

DP = ("pod", "data")  # logical data-parallel axes (the present subset is used)
TP = "model"
FSDP = "data"

__all__ = [
    "DP", "TP", "FSDP", "AbstractMesh", "LeafSpec", "ambient_mesh", "data_group",
    "data_parallel_mesh", "gather_rows", "global_max", "global_rows",
    "leaf_specs", "local_block", "mesh_axis_sizes", "mesh_context", "model_group",
    "param_spec", "param_specs", "require_live", "resolve_spec", "row_shard",
    "rows_replicated",
]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no process group: a mesh to size, not to run on."""

    axis_sizes: tuple
    axis_names: tuple

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def require_live(mesh, what: str) -> None:
    """Raise unless ``mesh`` is a live ``DeviceMesh`` this rank belongs to:
    a mesh without a process group never runs quietly unsharded."""
    if isinstance(mesh, AbstractMesh):
        raise ValueError(f"{what}: {mesh} has no process group; an AbstractMesh sizes a "
                         f"deployment (launch/dryrun.py) and cannot run one")
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or not torch.distributed.is_initialized():
        raise ValueError(f"{what} needs a torch DeviceMesh over an initialized process "
                         f"group, got {type(mesh).__name__}")
    if mesh.get_coordinate() is None:
        raise ValueError(f"{what}: rank {torch.distributed.get_rank()} is not part of "
                         f"this mesh")


def mesh_axis_sizes(mesh=None) -> dict:
    """``{axis name: size}`` of ``mesh`` (default: the ambient mesh); ``{}`` without one."""
    m = mesh if mesh is not None else ambient_mesh()
    if m is None:
        return {}
    if isinstance(m, AbstractMesh):
        return dict(zip(m.axis_names, m.axis_sizes))
    return dict(zip(m.mesh_dim_names, tuple(m.mesh.shape)))


# ------------------------------------------------------------ ambient mesh
class _State(threading.local):
    def __init__(self):
        self.mesh = None
        self.rows = False  # the activations' leading dimension is sharded over DP


_STATE = _State()


def ambient_mesh():
    """The mesh installed by :func:`mesh_context`, or None."""
    return _STATE.mesh


@contextlib.contextmanager
def mesh_context(mesh, *, rows: bool = True):
    """Install ``mesh`` for the code below; ``rows`` says whether the
    activations' leading dimension is split over the mesh's data axes
    (each rank holds its own contiguous rows)."""
    saved = (_STATE.mesh, _STATE.rows)
    _STATE.mesh, _STATE.rows = mesh, bool(rows) and mesh is not None
    try:
        yield mesh
    finally:
        _STATE.mesh, _STATE.rows = saved


@contextlib.contextmanager
def rows_replicated():
    """Keep the mesh, but every rank holds the same rows (no row collective)."""
    saved = _STATE.rows
    _STATE.rows = False
    try:
        yield
    finally:
        _STATE.rows = saved


def _dp_dim(mesh) -> Optional[str]:
    """The one data axis of a live mesh with more than one rank, or None."""
    big = [a for a in DP if a in mesh.mesh_dim_names and mesh.size(
        mesh.mesh_dim_names.index(a)) > 1]
    if len(big) > 1:
        raise ValueError(f"a live mesh splits rows over one data axis; {mesh} has "
                         f"{big} both larger than 1")
    return big[0] if big else None


def data_group(mesh):
    """(process group, this rank's index, size) of the data axis of a live
    mesh; ``(None, 0, 1)`` where that axis has one rank or is absent."""
    if mesh is None or isinstance(mesh, AbstractMesh):
        return None, 0, 1
    dim = _dp_dim(mesh)
    if dim is None:
        return None, 0, 1
    idx = mesh.mesh_dim_names.index(dim)
    return mesh.get_group(dim), mesh.get_local_rank(dim), mesh.size(idx)


def model_group(mesh):
    """(process group, this rank's index, size) of the model axis; as
    :func:`data_group`."""
    if mesh is None or isinstance(mesh, AbstractMesh) or TP not in mesh.mesh_dim_names:
        return None, 0, 1
    idx = mesh.mesh_dim_names.index(TP)
    if mesh.size(idx) == 1:
        return None, 0, 1
    return mesh.get_group(TP), mesh.get_local_rank(TP), mesh.size(idx)


def row_shard():
    """(group, index, size) of the rows of the current computation: the
    ambient live mesh's data group while its rows are sharded, else
    ``(None, 0, 1)``."""
    if not _STATE.rows:
        return None, 0, 1
    return data_group(_STATE.mesh)


def global_max(t: torch.Tensor) -> torch.Tensor:
    """(a): ``t`` (an absmax) as the max over every rank's rows."""
    group, _, size = row_shard()
    if size == 1:
        return t
    t = t.clone()
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX, group=group)
    return t


def global_rows(m: int) -> tuple:
    """(b): ``(m_global, start)`` for a tensor of ``m`` local rows: draw
    ``m_global`` rows and keep ``[start, start + m)``."""
    _, idx, size = row_shard()
    return m * size, idx * m


def gather_rows(x: torch.Tensor, group=None, size: Optional[int] = None) -> torch.Tensor:
    """Every rank's rows of ``x``, in rank order (an all-gather over the
    data group of the current rows, or over ``group`` of ``size`` ranks)."""
    if group is None and size is None:
        group, _, size = row_shard()
    if size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    torch.distributed.all_gather(parts, x, group=group)
    return torch.cat(parts)


def data_parallel_mesh(batch_size: Optional[int] = None, *, device=None):
    """A 1-D ``("data",)`` serving mesh over the ranks of the default
    process group, or None.

    Takes the largest world size that divides ``batch_size`` (every rank
    when it is None); ranks past that size are not part of the mesh and
    sit out (``mesh.get_coordinate()`` is None there).  Returns None
    without an initialized process group, on one rank, or when nothing
    larger than 1 divides, as the reference does on one device.  The mesh
    lives on ``device``'s type (default ``cuda``)."""
    if not torch.distributed.is_initialized():
        return None
    world = torch.distributed.get_world_size()
    n = world
    if batch_size is not None:
        while n > 1 and batch_size % n:
            n -= 1
    if n <= 1:
        return None
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    device_type = torch.device(device).type if device is not None else "cuda"
    if n == world:
        return init_device_mesh(device_type, (n,), mesh_dim_names=("data",))
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=("data",))


# --------------------------------------------------------------- the rules
def _resolve_entry(entry, dim: int, sizes: dict):
    """Keep only mesh-present axes; drop the entry unless dim divides."""
    if entry is None:
        return None
    axes = entry if isinstance(entry, tuple) else (entry,)
    axes = tuple(a for a in axes if a in sizes)
    if not axes:
        return None
    total = 1
    for a in axes:
        total *= sizes[a]
    if dim % total != 0:
        # try a shrinking prefix (e.g. ("pod", "data") -> ("pod",))
        for k in range(len(axes) - 1, 0, -1):
            tot = 1
            for a in axes[:k]:
                tot *= sizes[a]
            if dim % tot == 0:
                return axes[:k] if k > 1 else axes[0]
        return None
    return axes if len(axes) > 1 else axes[0]


def resolve_spec(spec: tuple, shape: tuple, sizes: dict) -> tuple:
    assert len(spec) == len(shape), (spec, shape)
    return tuple(_resolve_entry(e, d, sizes) for e, d in zip(spec, shape))


# Parameter rules by the reference's tree path (joined with '/'): a
# trailing-dims spec, leading (stacked) dims padded with None; the first
# match wins.
_RULES: list[tuple[str, tuple]] = [
    (r"embed", (TP, FSDP)),  # (vocab, d_model)
    (r"lm_head", (FSDP, TP)),  # (d_model, vocab)
    (r"(wq|wk|wv)$", (FSDP, TP)),  # (d_model, heads*hd)
    (r"wo$", (TP, FSDP)),  # (heads*hd, d_model)
    (r"(w1|w3)$", (FSDP, TP)),  # (d_model, d_ff)
    (r"w2$", (TP, FSDP)),  # (d_ff, d_model)
    (r"router", (FSDP, None)),  # (d_model, experts)
    (r"(we1|we3)$", (TP, FSDP, None)),  # (experts, d_model, ff)
    (r"we2$", (TP, None, FSDP)),  # (experts, ff, d_model)
    (r"(in_proj|gate_proj|x_proj)$", (FSDP, TP)),
    (r"out_proj$", (TP, FSDP)),
    (r"conv_w$", (None, TP)),  # (conv_width, channels)
    (r"(lru_a|lru_gate_w|lru_gate_b|conv_b)", None),  # small recurrent params
    (r"(ssm_a|ssm_d|dt_bias)$", (None,)),  # (heads,)
    (r"(norm|scale|bias)", None),  # norms etc: replicate
    (r"(^|/)(ln|post_ln)\d*$", None),  # layer-norm scales: replicate
    (r"(cross_wq|cross_wk|cross_wv)$", (FSDP, TP)),
    (r"cross_wo$", (TP, FSDP)),
]


def param_spec(path: str, shape: tuple, sizes: dict, *, fsdp: bool = True) -> tuple:
    """The spec of one parameter leaf at the reference's ``path`` and
    ``shape``; ``()`` replicates.  ``fsdp=False`` drops the data-axis
    (ZeRO-3) sharding: parameters and moments are then replicated over
    data and split over model only."""
    def strip(entry):
        if not fsdp:
            if entry == FSDP:
                return None
            if isinstance(entry, tuple):
                entry = tuple(a for a in entry if a != FSDP) or None
        return entry

    for pat, spec in _RULES:
        if re.search(pat, path):
            if spec is None:
                return ()
            spec = tuple(spec[-len(shape):]) if len(spec) <= len(shape) else spec
            full = (None,) * (len(shape) - len(spec)) + tuple(spec)
            full = tuple(strip(e) for e in full)
            return resolve_spec(full, shape, sizes)
    if len(shape) < 2 or not fsdp:  # unmatched vectors and scalars: replicate
        return ()
    # default: FSDP on the largest divisible dimension
    best, best_dim = None, 0
    for i, d in enumerate(shape):
        if d > best_dim and sizes.get(FSDP, 1) > 0 and d % max(sizes.get(FSDP, 1), 1) == 0:
            best, best_dim = i, d
    spec = [None] * len(shape)
    if best is not None and sizes.get(FSDP):
        spec[best] = FSDP
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One leaf of the reference's parameter tree, with its spec."""

    path: tuple  # key path in the reference's tree
    names: tuple  # the port's tensors in it, in layer order for a stacked leaf
    shape: tuple  # the leaf's shape in the reference's tree (stacked: layers first)
    spec: tuple  # its spec over ``shape`` (``()`` replicates)
    stacked: bool

    @property
    def layer_spec(self) -> tuple:
        """The spec of each of the port's tensors: the stacked entry dropped
        (a per-layer tensor is replicated over an axis that split the
        layers; see the module's note)."""
        if not self.stacked or not self.spec:
            return self.spec
        return self.spec[1:]


def _path_str(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def leaf_specs(params, mesh, *, fsdp: bool = True) -> list:
    """:class:`LeafSpec` of every leaf of the reference's tree for the
    port's ``params`` (real or meta tensors), in ``tree_leaves`` order."""
    from repro_torch.models.registry import STACKS, reference_leaves

    sizes = mesh_axis_sizes(mesh)
    named = dict(params.named_parameters())
    out = []
    for leaf in reference_leaves(params):
        stacked = leaf.path[0] in STACKS
        shape = tuple(named[leaf.names[0]].shape)
        if stacked:
            shape = (len(leaf.names),) + shape
        spec = param_spec(_path_str(leaf.path), shape, sizes, fsdp=fsdp)
        out.append(LeafSpec(leaf.path, leaf.names, shape, spec, stacked))
    return out


def param_specs(params, mesh, *, fsdp: bool = True) -> dict:
    """The port's parameter name -> the spec of that per-layer tensor."""
    return {name: ls.layer_spec for ls in leaf_specs(params, mesh, fsdp=fsdp)
            for name in ls.names}


def local_block(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` on a live mesh (a view;
    every dimension a spec splits divides by construction)."""
    coord = mesh.get_coordinate()
    out = full
    for mdim, axis in enumerate(mesh.mesh_dim_names):
        for d, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            if entry is not None and axis in axes:
                n = mesh.size(mdim)
                step = out.shape[d] // n
                out = out.narrow(d, coord[mdim] * step, step)
    return out
