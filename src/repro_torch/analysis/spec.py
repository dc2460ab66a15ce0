"""Trace specifications: what to trace and under which input contract.

Counterpart of ``repro/analysis/spec.py``.  A :class:`TraceSpec` is the
unit the certifier consumes: a callable, abstract inputs (shapes and
dtypes) and the *value contract* of each input (a quantized magnitude
plane is ``[0, 2^n - 1]`` and integer-valued, not its carrier's whole
range).  The kernel modules export ``audit_trace`` builders returning
these, so a contract lives next to the code it describes.

The trace is an aten-level ``torch.fx`` graph from
``make_fx(fn, tracing_mode="fake")``: fake tensors carry shapes and
dtypes and nothing executes.  Python loops (the n cycles of the
recurrence, the key blocks of the attention) unroll in the trace, which
is the port's form of the reference's loop unrolling with refinement.
A body that branches on tensor data cannot be fake-traced; the port's
bodies branch on shapes and arguments only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from repro_torch.analysis.domain import carrier_bounds, is_integer_dtype

__all__ = ["TraceSpec", "ValueRange", "sds", "trace"]


@dataclasses.dataclass(frozen=True)
class ValueRange:
    """Value contract of one traced input: elementwise bounds and whether
    every element is a mathematical integer (whatever the carrier)."""

    lo: float
    hi: float
    int_valued: bool = False

    @staticmethod
    def quantized(n: int) -> "ValueRange":
        """Magnitude plane of an n-bit quantizer: ``[0, 2^n - 1]``."""
        return ValueRange(0.0, float((1 << n) - 1), int_valued=True)

    @staticmethod
    def sign() -> "ValueRange":
        return ValueRange(-1.0, 1.0, int_valued=True)

    @staticmethod
    def carrier(dtype: torch.dtype) -> "ValueRange":
        """The whole range ``dtype`` holds (no contract)."""
        lo, hi = carrier_bounds(dtype)
        return ValueRange(lo, hi, int_valued=is_integer_dtype(dtype))


def sds(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """An abstract traced input: a ``meta`` tensor of ``shape`` and ``dtype``
    (no storage; the tracer turns it into a fake tensor)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def trace(fn: Callable[..., Any], args: Sequence[Any]) -> torch.fx.GraphModule:
    """The aten graph of ``fn`` on abstract ``args``: fake tensors on the
    CPU, so a wrapper takes its plain (CPU) branch; constants that ``fn``
    closes over (tables, factors) stay real and are read by value."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:  # fake CPU tensors of the args' shapes: no storage is allocated
        fakes = [torch.empty(a.shape, dtype=a.dtype)
                 if isinstance(a, torch.Tensor) and a.device.type == "meta" else a for a in args]
        return make_fx(fn, tracing_mode="real", _allow_non_fake_inputs=True)(*fakes)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """One auditable trace: a callable, its abstract inputs, a contract.

    ``ranges`` maps positionally onto ``args``; ``None`` entries fall back
    to the carrier range of the arg's dtype.  ``exact_products`` gates
    integer-valued float intermediates past their dtype's exact range
    before any reduction (the bit-exact parity contract); off for
    float-valued paths (the lowrank correction, fakequant).
    ``out_ranges`` are the caller-facing claims the outputs must satisfy
    (``None``: unconstrained): the packed single-word product is consumed
    as a non-negative int32 payload, so its contract is ``[0, 2^31 - 1]``.
    ``frontier`` and ``contract_n`` name, where the port's carriers admit
    more than the reference's dispatch bound, the two bounds the
    certificate records.
    """

    name: str
    fn: Callable[..., Any]
    args: Sequence[Any]
    ranges: Sequence[ValueRange | None] = ()
    exact_products: bool = True
    out_ranges: Sequence[ValueRange | None] = ()
    out_contract_reason: str = ""
    facts: dict = dataclasses.field(default_factory=dict)

    def trace(self) -> torch.fx.GraphModule:
        return trace(self.fn, self.args)

    def input_ranges(self) -> list[ValueRange]:
        ranges = list(self.ranges) + [None] * (len(self.args) - len(self.ranges))
        return [rng if rng is not None else ValueRange.carrier(arg.dtype)
                for arg, rng in zip(self.args, ranges)]

