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

**Tensor parallelism** (the second half of the module).  Where the
reference hints heads, d_ff and the vocabulary onto the model axis with
``constrain`` and lets GSPMD insert the collectives, the port issues them
itself.  :func:`place_params` replaces each parameter by its local block
under its per-layer spec and records the spec on it (``p.spec``); a layer
reads from the spec which dimension is split (:func:`tp_role`: a weight
whose output dimension holds the model axis is column-parallel, one whose
input dimension holds it row-parallel), never from the arch.  Before use,
:func:`use` gathers a leaf over the data axis it is FSDP-split over (its
gradient reduce-scattered back), or, for a leaf replicated over a data
axis, passes it through with its gradient all-reduced over that axis.
The model-axis collectives are ``torch.autograd.Function`` pairs:
:func:`copy_to` (identity, all-reduce backward) before a column-parallel
product and :func:`reduce_from` (all-reduce, identity backward) after a
row-parallel one; :func:`all_gather` (reduce-scatter backward) and
:func:`reduce_scatter` (all-gather backward) along a dimension.  Gloo has
no reduce-scatter, so :func:`reduce_scatter` is an all-reduce after which
each rank keeps its slice, under gloo and NCCL alike, so both give the
same bits; it moves the whole buffer, and is counted so.  Two more
pairs serve a computation every rank carries whole: :func:`all_gather_keep`
(all-gather, the backward keeping this rank's slice of a gradient every
rank holds whole) and :func:`split` (this rank's slice, all-gather
backward), which the sequence-sharded residual stream uses
(:func:`seq_parallel`: row-parallel outputs reduce-scattered over the
sequence, :func:`row_output`); :func:`data_mean` is an all-reduced mean
whose gradient is its adjoint (the MoE's aux statistics).  Every
collective, the row couplings (a)-(c) above included, goes through
:func:`_collective`, which counts the bytes it
issues by kind (:func:`counting`), calls the
collective on a one-rank group too (the card runs them there), and on an
:class:`AbstractMesh` runs nothing and returns the result's shape, so the
dry-run counts a sharded step's collectives on ``meta`` tensors from the
calls that step makes.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
from typing import NamedTuple, Optional

import torch

DP = ("pod", "data")  # logical data-parallel axes (the present subset is used)
TP = "model"
FSDP = "data"

__all__ = [
    "DP", "TP", "FSDP", "RS_AS_ALL_REDUCE", "AbstractMesh", "Axis", "LeafSpec", "Shard",
    "all_gather", "all_gather_keep", "all_reduce", "all_reduce_max", "ambient_mesh", "copy_to",
    "counting", "data_group", "data_mean", "data_parallel_mesh", "gather", "gather_block",
    "gather_rows", "global_max", "global_rows", "heads_split", "is_placed", "leaf_specs",
    "local_block", "local_size", "mesh_axis", "mesh_axis_sizes", "mesh_context", "model_axis",
    "param_spec", "param_specs", "place_params", "reduce_from", "reduce_scatter",
    "require_live", "resolve_spec", "row_axis", "row_output", "row_shard", "rows_replicated",
    "seq_parallel", "spec_axes", "split", "splits", "tp_role", "use",
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
class _State:
    """The ambient mesh, process-wide: autograd runs a CUDA backward (and a
    remat block's recompute within it) on a device thread of its own, which
    must see the mesh its forward ran under."""

    def __init__(self):
        self.mesh = None
        self.rows = False  # the activations' leading dimension is sharded over DP
        self.heads = None  # the Axis an attention's heads are split over, or None
        self.seq = None  # the Axis a block's residual sequence is split over, or None


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


def row_axis() -> Optional["Axis"]:
    """The axis the rows of the current computation are split over: the
    ambient mesh's data axis with more than one rank while its rows are
    sharded, else None.  On an :class:`AbstractMesh` it stands for every
    data axis at once (``pod`` x ``data``), at index 0."""
    mesh = _STATE.mesh
    if not _STATE.rows or mesh is None:
        return None
    if isinstance(mesh, AbstractMesh):
        sizes = mesh_axis_sizes(mesh)
        names = [a for a in DP if sizes.get(a, 1) > 1]
        size = 1
        for a in names:
            size *= sizes[a]
        return Axis("+".join(names), None, 0, size) if size > 1 else None
    dim = _dp_dim(mesh)
    return None if dim is None else mesh_axis(mesh, dim)


def row_shard():
    """(group, index, size) of the rows of the current computation
    (:func:`row_axis`), else ``(None, 0, 1)``."""
    ax = row_axis()
    return (None, 0, 1) if ax is None else (ax.group, ax.index, ax.size)


@contextlib.contextmanager
def heads_split(ax):
    """Within, the attention's heads are split over ``ax`` (tensor
    parallelism): :func:`global_max` takes the max over it too, so the
    approximate attention's per-tensor q, k and v scales are the whole
    tensors'."""
    saved = _STATE.heads
    _STATE.heads = ax
    try:
        yield
    finally:
        _STATE.heads = saved


def global_max(t: torch.Tensor) -> torch.Tensor:
    """(a): ``t`` (an absmax) as the max over every rank's rows (and, within
    :func:`heads_split`, over the ranks the heads are split over)."""
    t = all_reduce_max(t, row_axis())
    if _STATE.heads is not None:
        t = all_reduce_max(t, _STATE.heads)
    return t


def global_rows(m: int) -> tuple:
    """(b): ``(m_global, start)`` for a tensor of ``m`` local rows: draw
    ``m_global`` rows and keep ``[start, start + m)``."""
    _, idx, size = row_shard()
    return m * size, idx * m


def gather_rows(x: torch.Tensor, group=None, size: Optional[int] = None) -> torch.Tensor:
    """Every rank's rows of ``x``, in rank order: an all-gather along the
    first dimension over ``group`` (an :class:`Axis`, or a process group of
    ``size`` ranks; default: :func:`row_axis`), whose gradient is
    reduce-scattered back (:func:`all_gather`)."""
    if isinstance(group, Axis) or (group is None and size is None):
        ax = group if group is not None else row_axis()
    elif size is None or size == 1:
        return x
    else:
        ax = Axis(FSDP, group, torch.distributed.get_rank(group), size)
    return x if ax is None or ax.size == 1 else all_gather(x, ax, 0)


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
    def ndim(self) -> int:
        """The leaf's rank in the reference's tree (stacking adds one)."""
        return len(self.shape)

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


def _layout(mesh) -> tuple:
    """(axis names, sizes, this rank's coordinate) of a live mesh, or of an
    :class:`AbstractMesh` at coordinate 0 (every block has its shape)."""
    if isinstance(mesh, AbstractMesh):
        return tuple(mesh.axis_names), tuple(mesh.axis_sizes), (0,) * len(mesh.axis_sizes)
    names = tuple(mesh.mesh_dim_names)
    return names, tuple(mesh.size(i) for i in range(len(names))), tuple(mesh.get_coordinate())


def spec_axes(entry) -> tuple:
    """The axis names of one spec entry (``None``, a name or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_block(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` on a live mesh, or the
    block at coordinate 0 of an :class:`AbstractMesh` (a view; every
    dimension a spec splits divides by construction)."""
    names, sizes, coord = _layout(mesh)
    out = full
    for mdim, axis in enumerate(names):
        for d, entry in enumerate(spec):
            if axis in spec_axes(entry):
                n = sizes[mdim]
                step = out.shape[d] // n
                out = out.narrow(d, coord[mdim] * step, step)
    return out


def gather_block(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The inverse of :func:`local_block`: the whole tensor from every
    rank's block (all-gathers over each split axis, innermost mesh
    dimension first; no gradient)."""
    names = _layout(mesh)[0]
    out = local
    for axis in reversed(names):
        ax = mesh_axis(mesh, axis)
        for d, entry in enumerate(spec):
            if axis in spec_axes(entry):
                out = _collective("all-gather", out, ax, dim=d)
    return out


# ------------------------------------------------------ tensor parallelism
@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh: its process group (None on an
    :class:`AbstractMesh`), this rank's index along it and its size."""

    name: str
    group: object
    index: int
    size: int

    @property
    def abstract(self) -> bool:
        return self.group is None


class Shard(NamedTuple):
    """A GEMM's tensor-parallel role: ``"column"`` (the weight's output
    dimension split over ``axis``) or ``"row"`` (its input dimension)."""

    role: str
    axis: Axis


def mesh_axis(mesh, name: str) -> Optional[Axis]:
    """Axis ``name`` of ``mesh`` (default: the ambient mesh), with its
    group even where it has one rank; None without a mesh or that axis."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        return None
    names, sizes, coord = _layout(mesh)
    if name not in names:
        return None
    i = names.index(name)
    group = None if isinstance(mesh, AbstractMesh) else mesh.get_group(name)
    return Axis(name, group, coord[i], sizes[i])


def model_axis(mesh=None) -> Optional[Axis]:
    """The model axis of ``mesh`` (default: the ambient mesh), or None."""
    return mesh_axis(mesh, TP)


_COUNTERS: list = []
RS_AS_ALL_REDUCE = "all-reduce for reduce-scatter"  # the counted kind of a reduce-scatter


@contextlib.contextmanager
def counting():
    """Within, every collective adds the bytes it issues to the yielded
    ``Counter`` under its kind: ``all-reduce`` and ``all-gather`` their
    result buffer's, as the reference's HLO analysis counts them, and
    :data:`RS_AS_ALL_REDUCE` the whole buffer of the all-reduce that stands
    in for a reduce-scatter (the module's note), ``m`` times the
    reduce-scatter's result over ``m`` ranks."""
    counter = collections.Counter()
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


def _collective(kind: str, t: torch.Tensor, ax: Axis, *, dim: int = 0,
                op: str = "sum") -> torch.Tensor:
    """The one place every tensor-parallel collective passes: counted, then
    run over ``ax`` (on an abstract axis only shaped).  ``all-reduce``
    (``op`` sum or max) returns a new tensor; ``all-gather`` concatenates
    the ranks' ``t`` along ``dim`` in rank order; ``reduce-scatter`` sums
    and keeps this rank's slice along ``dim``."""
    if kind == "all-gather":
        shape = list(t.shape)
        shape[dim] *= ax.size
        nbytes = t.numel() * ax.size * t.element_size()
    else:  # a reduce-scatter is issued as an all-reduce of the whole buffer
        nbytes = t.numel() * t.element_size()
    for counter in _COUNTERS:
        counter[RS_AS_ALL_REDUCE if kind == "reduce-scatter" else kind] += nbytes
    if ax.abstract:
        if kind == "all-gather":
            return t.new_empty(shape) if t.device.type == "meta" else torch.cat([t] * ax.size, dim)
        if kind == "reduce-scatter":
            return t.narrow(dim, ax.index * (t.shape[dim] // ax.size), t.shape[dim] // ax.size)
        return t.clone()
    dist = torch.distributed
    if kind == "all-gather":  # into one tensor, ranks along dim 0, then moved to dim
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((ax.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=ax.group)
        return out.movedim(0, dim).contiguous() if dim % t.ndim else out
    out = t.contiguous().clone()
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    dist.all_reduce(out, op=red, group=ax.group)
    if kind == "reduce-scatter":  # gloo has none: all-reduce, keep this rank's slice
        step = out.shape[dim] // ax.size
        out = out.narrow(dim, ax.index * step, step).contiguous()
    return out


def all_reduce(t: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The sum over ``ax`` (no gradient); ``t`` unchanged without an axis."""
    return t if ax is None else _collective("all-reduce", t, ax)


def gather(t: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """All-gather along ``dim`` over ``ax`` with no gradient (a result every
    rank then holds whole, such as the serving logits)."""
    return t if ax is None else _collective("all-gather", t.detach(), ax, dim=dim)


def all_reduce_max(t: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The max over ``ax`` (no gradient); ``t`` unchanged without an axis."""
    return t if ax is None else _collective("all-reduce", t, ax, op="max")


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _collective("all-reduce", g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _collective("all-reduce", x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _collective("all-gather", x, ax, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _collective("reduce-scatter", g, ctx.ax, dim=ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _collective("reduce-scatter", x, ax, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _collective("all-gather", g, ctx.ax, dim=ctx.dim), None, None


def copy_to(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Identity forward, all-reduce backward over ``ax``: the input of a
    column-parallel product, whose every rank adds a part of its gradient."""
    if ax is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyTo.apply(x, ax)


def reduce_from(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """All-reduce forward, identity backward over ``ax``: the sum of a
    row-parallel product's partials."""
    if ax is None:
        return x
    if not torch.is_grad_enabled():  # serving: the collective alone
        return _collective("all-reduce", x, ax)
    return _ReduceFrom.apply(x, ax)


def all_gather(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """All-gather along ``dim`` over ``ax``, reduce-scatter backward (the
    ranks' gradients of the gathered tensor are parts of one sum)."""
    if ax is None:
        return x
    if not torch.is_grad_enabled():
        return _collective("all-gather", x, ax, dim=dim)
    return _AllGather.apply(x, ax, dim)


def reduce_scatter(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """Sum over ``ax``, keep this rank's slice along ``dim``; all-gather backward."""
    if ax is None:
        return x
    if not torch.is_grad_enabled():
        return _collective("reduce-scatter", x, ax, dim=dim)
    return _ReduceScatter.apply(x, ax, dim)


class _AllGatherKeep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _collective("all-gather", x, ax, dim=dim)

    @staticmethod
    def backward(ctx, g):
        step = g.shape[ctx.dim] // ctx.ax.size
        return g.narrow(ctx.dim, ctx.ax.index * step, step), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        step = x.shape[dim] // ax.size
        return x.narrow(dim, ax.index * step, step)

    @staticmethod
    def backward(ctx, g):
        return _collective("all-gather", g.contiguous(), ctx.ax, dim=ctx.dim), None, None


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _collective("all-reduce", x, ax) / torch.full((), float(ax.size), device=x.device)

    @staticmethod
    def backward(ctx, g):
        n = torch.full((), float(ctx.ax.size), device=g.device)
        return _collective("all-reduce", g, ctx.ax) / n, None


def all_gather_keep(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """All-gather along ``dim`` over ``ax``, for a result whose every rank
    then carries the whole gradient (the computation after it replicated,
    or summed over ``ax`` by its own collectives): the backward keeps this
    rank's slice of it, with no collective."""
    if ax is None:
        return x
    if not torch.is_grad_enabled():
        return _collective("all-gather", x, ax, dim=dim)
    return _AllGatherKeep.apply(x, ax, dim)


def split(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of a tensor every rank holds whole
    (no collective); the backward all-gathers the slices' gradients, so
    every rank carries the whole gradient again."""
    if ax is None:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        step = x.shape[dim] // ax.size
        return x.narrow(dim, ax.index * step, step)
    return _Split.apply(x, ax, dim)


def data_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``t`` over the data ranks of ``mesh`` (every ``DP`` axis
    it has), the gradient its adjoint (the all-reduced mean): each data
    rank's loss holds its share of a statistic the ranks compute together
    (the MoE's load-balance loss: ``train/steps.loss_fn``)."""
    for name in DP:
        ax = mesh_axis(mesh, name)
        if ax is not None:
            t = _DataMean.apply(t, ax) if torch.is_grad_enabled() else (
                _collective("all-reduce", t, ax) / torch.full((), float(ax.size),
                                                             device=t.device))
    return t


def local_size(dim: int, ax: Optional[Axis]) -> int:
    """A dimension's extent on one rank where ``ax`` splits it (it divides
    by the axis's size), else the whole extent, as :func:`resolve_spec`
    degrades."""
    return dim // ax.size if ax is not None and dim % ax.size == 0 else dim


def splits(dim: int, ax: Optional[Axis]) -> bool:
    """Whether ``ax`` splits a dimension of extent ``dim`` (:func:`local_size`)."""
    return ax is not None and dim % ax.size == 0


@contextlib.contextmanager
def seq_parallel(ax: Optional[Axis]):
    """Within, a decoder block's residual stream is split over its
    sequence on ``ax`` (``cfg.seq_shard_residuals``): the block gathers its
    input's sequence, and the sum of each row-parallel output is a
    reduce-scatter over the sequence (:func:`row_output`)."""
    saved = _STATE.seq
    _STATE.seq = ax
    try:
        yield
    finally:
        _STATE.seq = saved


def row_output(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The sum over ``ax`` of a row-parallel output ``x`` (B, S, N): an
    all-reduce (:func:`reduce_from`), or within :func:`seq_parallel` a
    reduce-scatter over the sequence (dimension 1)."""
    if ax is not None and _STATE.seq is not None and x.ndim == 3:
        return reduce_scatter(x, ax, 1)
    return reduce_from(x, ax)


def tp_role(spec: Optional[tuple]) -> Optional[str]:
    """``"column"`` where a 2-D weight's output dimension holds the model
    axis, ``"row"`` where its input dimension does, else None."""
    if not spec or len(spec) != 2:
        return None
    if TP in spec_axes(spec[-1]):
        return "column"
    if TP in spec_axes(spec[0]):
        return "row"
    return None


def is_placed(params) -> bool:
    """Whether ``params`` (a model's module) holds local blocks (:func:`place_params`)."""
    return getattr(params, "placed_on", None) is not None


def _set_param(module, name: str, p: torch.nn.Parameter) -> None:
    *path, last = name.split(".")
    for key in path:
        module = getattr(module, key)
    module.register_parameter(last, p)


def _held(ls: LeafSpec, blocks: dict, mesh) -> LeafSpec:
    """``ls`` with the spec its :class:`~repro_torch.checkpoint.manager.Placed`
    leaves hold their blocks under (those leaves must lie on ``mesh``)."""
    layer = {tuple(blocks[n].spec) for n in ls.names}
    if len(layer) != 1:
        raise ValueError(f"{_path_str(ls.path)}: its layers' blocks lie under different specs "
                         f"({sorted(layer)})")
    if any(blocks[n].mesh is not mesh and blocks[n].mesh != mesh for n in ls.names):
        raise ValueError(f"{_path_str(ls.path)}: its blocks lie on another mesh than {mesh}")
    (layer,) = layer
    return dataclasses.replace(ls, spec=(None,) + layer if ls.stacked and layer else layer)


def place_params(params, mesh, *, fsdp: bool = True, blocks=None):
    """In place: every parameter of ``params`` becomes its block under its
    per-layer spec (``leaf_specs`` with ``fsdp``) on ``mesh``, with
    ``p.spec`` set, ``params.placed_on`` the mesh and
    ``params.placed_specs`` the :class:`LeafSpec` list (of the whole
    shapes); returns ``params``.  ``blocks`` (by parameter name) are
    :class:`~repro_torch.checkpoint.manager.Placed` leaves on ``mesh`` to
    hold instead: each parameter shares its leaf's storage and takes its
    leaf's spec, so the leaves stay the one record of where each block lies."""
    specs = leaf_specs(params, mesh, fsdp=fsdp)
    if blocks is not None:
        specs = [_held(ls, blocks, mesh) for ls in specs]
    for ls in specs:
        if ls.stacked and ls.spec and ls.spec[0] is not None:
            raise ValueError(f"{_path_str(ls.path)}: a spec that splits the stacked "
                             f"layers ({ls.spec}) has no per-layer block")
        for name in ls.names:
            old = params.get_parameter(name)
            if blocks is not None:
                block = blocks[name].local
            else:
                block = local_block(old.detach(), ls.layer_spec, mesh)
                block = block.clone() if block.numel() < old.numel() else block
            new = torch.nn.Parameter(block, requires_grad=old.requires_grad)
            new.spec = ls.layer_spec
            _set_param(params, name, new)
    params.placed_on = mesh
    params.placed_specs = specs
    return params


def use(p: torch.Tensor) -> torch.Tensor:
    """A placed leaf as its layer uses it: gathered over the data axis its
    spec splits it on (the gradient reduce-scattered), or, replicated over
    a data axis, passed on with its gradient all-reduced over it; the leaf
    itself where it is not placed."""
    spec = getattr(p, "spec", None)
    if spec is None:
        return p
    mesh = ambient_mesh()
    if mesh is None:
        raise ValueError("a placed parameter is used outside a mesh_context of its mesh")
    out = p
    for axis in DP:
        ax = mesh_axis(mesh, axis)
        if ax is None:
            continue
        dims = [d for d, e in enumerate(spec) if axis in spec_axes(e)]
        out = all_gather(out, ax, dims[0]) if dims else copy_to(out, ax)
    return out
