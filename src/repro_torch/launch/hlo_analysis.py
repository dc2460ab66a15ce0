"""FLOP and byte counts of a traced step: the port's roofline inputs.

Counterpart of ``repro/launch/hlo_analysis.py``, whose name it keeps so a
reader finds it; it reads an aten graph, not HLO.  The reference parses
the compiled, fused HLO and weights each op by its loops' trip counts.
The port has no compiler pass: a step runs on ``meta`` tensors under a
dispatch mode that sees every aten op (the backward's too), nothing
executes, and Python loops (the layers, the key blocks of an attention)
run as they would, so every op is counted as often as it runs.

- **FLOPs**: every matrix product (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``dot``, ``mv``) contributes ``2 x |result| x K``; each
  port kernel call (:func:`kernel_ops`: the GEMM kernels stand in the
  trace as one op each) contributes the GEMM it computes, the lowrank
  correction's ``2 M K N r`` included.  Elementwise work is not counted,
  as the reference counts only dots.
- **Bytes**: the eager model.  Each aten op or kernel launch moves its
  operands and its result once; views, shape ops and constants are free.
  This is what eager PyTorch moves, one kernel per op, and not the
  reference's fused-HLO model, where fusion internals stay on chip: the
  port's count is an upper bound that fusion would lower.
- **Per-op records** carry the module path: the port's frames of the
  Python stack at the op, outermost first (``models/moe.py:141:expert_gemm``
  and the like).
- **Collective bytes** are not counted here: the collectives of a sharded
  step pass through ``distributed.sharding``, which counts them by kind
  (``sharding.counting``); ``launch/dryrun.py`` reads them there.
"""

from __future__ import annotations

import dataclasses
import re
import traceback
from typing import Any, Callable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Analysis", "OpRecord", "analyze", "kernel_ops"]

_DOTS = ("mm", "bmm", "addmm", "baddbmm", "dot", "mv", "addmv", "matmul", "linear")
# ops that move no bytes: views and shape ops alias their operand
_FREE = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "unsqueeze", "squeeze", "permute",
    "transpose", "t", "slice", "select", "alias", "detach", "as_strided", "split",
    "split_with_sizes", "unbind", "chunk", "diagonal", "lift_fresh_copy", "lift_fresh",
    "view_as", "expand_as", "flatten", "unflatten", "sym_size", "getitem", "empty",
    "empty_like", "empty_strided", "new_empty", "_assert_tensor_metadata", "_assert_scalar",
    "scalar_tensor", "arange", "zeros", "ones", "full", "numpy_T", "mT", "T",
})


@dataclasses.dataclass
class OpRecord:
    name: str  # the aten op (overload packet) or the kernel
    op: str
    flops: float
    bytes: int
    module: str


@dataclasses.dataclass
class Analysis:
    flops: float
    bytes: float
    ops: list  # OpRecords of every op that moves bytes or does FLOPs
    collective_bytes: None = None

    def top_bytes(self, k: int = 10) -> list:
        return sorted(self.ops, key=lambda r: -r.bytes)[:k]

    def by_module(self, pattern: str) -> tuple[float, float]:
        """(FLOPs, bytes) of the ops whose module path matches ``pattern``."""
        rx = re.compile(pattern)
        mine = [r for r in self.ops if rx.search(r.module)]
        return sum(r.flops for r in mine), float(sum(r.bytes for r in mine))


def _nbytes(v: Any) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    if isinstance(v, (list, tuple)):
        return sum(_nbytes(x) for x in v)
    return 0


def _module(stack) -> str:
    """The port's frames of a Python stack, outermost first."""
    return "/".join(f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}:{f.name}" for f in stack
                    if "repro_torch" in f.filename and "launch/" not in f.filename)


class _Counter(TorchDispatchMode):
    """Counts every aten op dispatched under it (see the module's note)."""

    def __init__(self, where: bool):
        super().__init__()
        self.where = where
        self.flops, self.bytes, self.ops = 0.0, 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _FREE or name.startswith("_assert"):
            return out
        f, operands = 0.0, list(args) + list(kwargs.values())
        if name in _DOTS:
            lhs = args[1] if name in ("addmm", "baddbmm", "addmv") else args[0]
            f = 2.0 * _numel(out) * int(lhs.shape[-1])
        elif name == "einsum":
            f = _einsum_flops(args[0], args[1])
        elif name == "kernel_call":
            operands, name, f = args[0], args[1], float(args[2])
        b = _nbytes(out) + sum(_nbytes(a) for a in operands)
        self.flops += f
        self.bytes += b
        if f or b:
            where = _module(traceback.extract_stack()) if self.where else ""
            self.ops.append(OpRecord(name, str(func), f, b, where))
        return out


def _einsum_flops(equation: str, operands: Sequence[torch.Tensor]) -> float:
    """A contraction's multiply-adds, two FLOPs each: the product of every
    index's extent (one or two operands)."""
    sizes = {}
    for spec, x in zip(equation.split("->")[0].split(","), operands):
        for letter, dim in zip(spec.strip(), x.shape):
            sizes[letter] = int(dim)
    total = 1
    for dim in sizes.values():
        total *= dim
    return 2.0 * total if len(operands) > 1 else 0.0


def _numel(v: Any) -> int:
    return v.numel() if isinstance(v, torch.Tensor) else sum(_numel(x) for x in v)


# ------------------------------------------------------- the kernel calls
_KERNEL_OP = None


def _kernel_op():
    """``repro_torch::kernel_call(inputs, name, flops, rows, cols)``: one port
    kernel launch as a single op of the trace (registered at first use)."""
    global _KERNEL_OP
    if _KERNEL_OP is None:
        if not hasattr(torch.ops.repro_torch, "kernel_call"):
            @torch.library.custom_op("repro_torch::kernel_call", mutates_args=())
            def _call(inputs: list[torch.Tensor], name: str, flops: float, rows: int,
                      cols: int) -> torch.Tensor:
                return torch.zeros((rows, cols), dtype=torch.float32, device=inputs[0].device)

            @_call.register_fake
            def _(inputs, name, flops, rows, cols):
                return inputs[0].new_empty((rows, cols), dtype=torch.float32)
        _KERNEL_OP = torch.ops.repro_torch.kernel_call.default
    return _KERNEL_OP


def kernel_ops():
    """Within, the engine's GEMM kernels stand in a trace as one
    ``kernel_call`` op each (their operands, their (M, N) float32 result
    and the GEMM's FLOPs), as a launch moves and computes them."""
    from repro_torch.engine import modes

    def gemm(name, rank_of=lambda tensors: 0):
        def call(*tensors, **kw):
            a, b = tensors[-4], tensors[-2]  # the magnitudes (M, K) and (K, N)
            m, k, n_cols = a.shape[0], a.shape[1], b.shape[1]
            f = 2.0 * m * k * n_cols * (1 + rank_of(tensors))
            return _kernel_op()(list(tensors), name, f, m, n_cols)
        return call

    def packed(pa, pb, *, n=15, integer=False):
        m, kw, n_cols = pa.shape[0], pa.shape[1], pb.shape[1]
        return _kernel_op()([pa, pb], "packed_matmul", 2.0 * m * 2 * kw * n_cols, m, n_cols)

    return modes.substitute_kernels(
        lut_matmul=gemm("lut_matmul"), seqmul_matmul=gemm("seqmul_matmul"),
        lowrank_matmul=gemm("lowrank_matmul", rank_of=lambda ts: ts[0].shape[1]),
        packed_matmul=packed)


def analyze(fn: Callable[..., Any], args: Sequence[Any], *, where: bool = True) -> Analysis:
    """Run ``fn(*args)`` on ``meta`` tensors (nothing executes: each op only
    infers its result's shape) with the GEMM kernels as single ops, and
    count every aten op it dispatches, the backward's too where ``fn``
    takes gradients; ``where=False`` leaves out the records' module paths
    (a Python stack per op)."""
    counter = _Counter(where)
    with kernel_ops(), counter:
        fn(*args)
    return Analysis(flops=counter.flops, bytes=float(counter.bytes), ops=counter.ops)
