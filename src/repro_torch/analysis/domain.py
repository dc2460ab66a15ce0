"""The interval abstract domain the certifier interprets aten graphs over.

Counterpart of ``repro/analysis/domain.py`` (a copy: the port imports
nothing of the JAX package).  Every traced value is summarized by an
:class:`Interval`: elementwise bounds ``[lo, hi]`` plus the qualitative
bits that carry the paper's arithmetic contract through the dataflow:

``int_valued``
    every element is a mathematical integer, whatever its carrier dtype
    (a quantized magnitude held in float32 is still int-valued);
``reduced``
    the value has passed through a K-style reduction (a sum, ``mm``,
    ``cumsum`` over a real axis); a float accumulator's envelope scales
    with K and is reported as a derived fact, not gated;
``dominates``
    the graph nodes this value is a running elementwise upper bound of
    (seeded by ``amax`` / ``maximum``): ``exp(x - m)`` lies in ``[0, 1]``
    when ``m`` dominates ``x``, which proves the online-softmax
    probabilities, and so the ``U[p_int]`` / table gathers, in bounds.

Carriers are torch dtypes: the integer dtypes as torch has them (int8,
int16, int32, int64, uint8, uint16, uint32, bool), and the floats, whose
carrier range is unbounded but which hold every integer only up to
:func:`exact_int_limit` (2^24 for float32, 2^8 for bfloat16).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, FrozenSet

import torch

__all__ = [
    "F32_EXACT_INT", "Interval", "add", "bit_and", "bit_or", "carrier_bounds", "div",
    "exact_int_limit", "is_integer_dtype", "join_all", "max_", "min_", "monotone_unary", "mul",
    "shift_left", "shift_right", "sub",
]

# Largest integer magnitude exactly representable in float32: every
# integer in [-2^24, 2^24] round-trips.
F32_EXACT_INT = float(1 << 24)

_INF = math.inf
_EXACT_INT = {torch.float32: F32_EXACT_INT, torch.bfloat16: float(1 << 8),
              torch.float16: float(1 << 11), torch.float64: float(1 << 53)}


def is_integer_dtype(dtype: Any) -> bool:
    """An integer or bool carrier (bounded range)."""
    return isinstance(dtype, torch.dtype) and (dtype == torch.bool or not (
        dtype.is_floating_point or dtype.is_complex))


def carrier_bounds(dtype: Any) -> tuple[float, float]:
    """The values a carrier can hold; unbounded for floats and non-dtypes."""
    if not isinstance(dtype, torch.dtype):
        return (-_INF, _INF)
    if dtype == torch.bool:
        return (0.0, 1.0)
    if is_integer_dtype(dtype):
        info = torch.iinfo(dtype)
        return (float(info.min), float(info.max))
    return (-_INF, _INF)


def exact_int_limit(dtype: Any) -> float:
    """Largest integer magnitude below which a float carrier holds every
    integer (``inf`` for integer carriers and unknown dtypes)."""
    return _EXACT_INT.get(dtype, _INF)


@dataclasses.dataclass(frozen=True)
class Interval:
    lo: float
    hi: float
    int_valued: bool = False
    reduced: bool = False
    dominates: FrozenSet[Any] = frozenset()

    def __post_init__(self) -> None:
        if self.lo > self.hi:  # pragma: no cover - domain invariant
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    # -- constructors ------------------------------------------------
    @staticmethod
    def point(v: float, int_valued: bool | None = None) -> "Interval":
        if int_valued is None:
            int_valued = math.isfinite(v) and float(v).is_integer()
        return Interval(float(v), float(v), int_valued=int_valued)

    @staticmethod
    def of_dtype(dtype: Any) -> "Interval":
        lo, hi = carrier_bounds(dtype)
        return Interval(lo, hi, int_valued=is_integer_dtype(dtype))

    @staticmethod
    def bool01() -> "Interval":
        return Interval(0.0, 1.0, int_valued=True)

    # -- predicates --------------------------------------------------
    @property
    def is_point(self) -> bool:
        return self.lo == self.hi and math.isfinite(self.lo)

    def fits(self, dtype: Any) -> bool:
        lo, hi = carrier_bounds(dtype)
        return self.lo >= lo and self.hi <= hi

    def magnitude(self) -> float:
        return max(abs(self.lo), abs(self.hi))

    # -- lattice -----------------------------------------------------
    def join(self, other: "Interval") -> "Interval":
        return Interval(
            min(self.lo, other.lo),
            max(self.hi, other.hi),
            int_valued=self.int_valued and other.int_valued,
            reduced=self.reduced or other.reduced,
            dominates=self.dominates & other.dominates,
        )

    def with_(self, **kw: Any) -> "Interval":
        return dataclasses.replace(self, **kw)


def join_all(ivals: list[Interval]) -> Interval:
    out = ivals[0]
    for iv in ivals[1:]:
        out = out.join(iv)
    return out


def _mul_bound(a: float, b: float) -> float:
    # inf * 0 in interval arithmetic is 0 (limits of products of bounds)
    if (a == 0.0 and math.isinf(b)) or (b == 0.0 and math.isinf(a)):
        return 0.0
    return a * b


def mul(a: Interval, b: Interval) -> Interval:
    cands = [_mul_bound(a.lo, b.lo), _mul_bound(a.lo, b.hi),
             _mul_bound(a.hi, b.lo), _mul_bound(a.hi, b.hi)]
    return Interval(min(cands), max(cands), int_valued=a.int_valued and b.int_valued,
                    reduced=a.reduced or b.reduced)


def _sum_bound(a: float, b: float, default: float) -> float:
    s = a + b
    return default if math.isnan(s) else s  # inf - inf: unbounded


def add(a: Interval, b: Interval) -> Interval:
    return Interval(_sum_bound(a.lo, b.lo, -_INF), _sum_bound(a.hi, b.hi, _INF),
                    int_valued=a.int_valued and b.int_valued, reduced=a.reduced or b.reduced)


def sub(a: Interval, b: Interval) -> Interval:
    return Interval(_sum_bound(a.lo, -b.hi, -_INF), _sum_bound(a.hi, -b.lo, _INF),
                    int_valued=a.int_valued and b.int_valued, reduced=a.reduced or b.reduced)


def div(a: Interval, b: Interval) -> Interval:
    if b.lo <= 0.0 <= b.hi:
        return Interval(-_INF, _INF, reduced=a.reduced or b.reduced)
    cands = [x / y if not (math.isinf(x) and math.isinf(y)) else _INF * (1 if x * y > 0 else -1)
             for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    return Interval(min(cands), max(cands), int_valued=False, reduced=a.reduced or b.reduced)


def min_(a: Interval, b: Interval) -> Interval:
    return Interval(min(a.lo, b.lo), min(a.hi, b.hi), int_valued=a.int_valued and b.int_valued,
                    reduced=a.reduced or b.reduced)


def max_(a: Interval, b: Interval, dominated: FrozenSet[Any] = frozenset()) -> Interval:
    return Interval(max(a.lo, b.lo), max(a.hi, b.hi), int_valued=a.int_valued and b.int_valued,
                    reduced=a.reduced or b.reduced,
                    dominates=a.dominates | b.dominates | dominated)


def shift_left(a: Interval, s: Interval) -> Interval:
    """Unclamped mathematical ``a * 2^s``: overflow is checked by the caller."""
    if not (a.int_valued and s.int_valued) or s.lo < 0:
        return Interval(-_INF, _INF, int_valued=a.int_valued and s.int_valued)
    cands = [_mul_bound(x, 2.0 ** y) for x in (a.lo, a.hi) for y in (s.lo, s.hi)]
    return Interval(min(cands), max(cands), int_valued=True, reduced=a.reduced or s.reduced)


def shift_right(a: Interval, s: Interval) -> Interval:
    """Arithmetic right shift: ``floor(a / 2^s)`` elementwise."""
    if s.lo < 0:
        return Interval(-_INF, _INF)

    def f(x: float, y: float) -> float:
        return math.floor(x / 2.0 ** y) if math.isfinite(x) and math.isfinite(y) else (
            x if math.isinf(x) else (0.0 if x >= 0 else -1.0))

    cands = [f(x, y) for x in (a.lo, a.hi) for y in (s.lo, s.hi)]
    return Interval(min(cands), max(cands), int_valued=True, reduced=a.reduced or s.reduced)


def bit_and(a: Interval, b: Interval) -> Interval:
    """Sound envelope for ``a & b``: a non-negative mask bounds the result
    whatever the other operand's sign (two's complement)."""
    red = a.reduced or b.reduced
    if a.lo >= 0 and b.lo >= 0:
        return Interval(0.0, min(a.hi, b.hi), int_valued=True, reduced=red)
    if a.lo >= 0:
        return Interval(0.0, a.hi, int_valued=True, reduced=red)
    if b.lo >= 0:
        return Interval(0.0, b.hi, int_valued=True, reduced=red)
    return Interval(-_INF, _INF, int_valued=a.int_valued and b.int_valued)


def _next_pow2_minus1(v: float) -> float:
    if not math.isfinite(v):
        return v
    if v <= 0:
        return 0.0
    return float((1 << int(v).bit_length()) - 1)


def bit_or(a: Interval, b: Interval, *, is_xor: bool = False) -> Interval:
    """Sound envelope for ``a | b`` / ``a ^ b`` on non-negative operands:
    never above the sum (``a|b <= a+b``) and never wider than the wider
    operand (``a|b < 2^bits(max(a, b))``).  The tightness matters: the
    recurrence's augend ``(s_lsp >> 1) | ((s_msp & 1) << (t-1))`` joins
    disjoint bit fields, and a doubling envelope would overstate every
    assembled product.  ``a ^ b`` shares the upper envelope but can
    cancel to 0."""
    if a.lo >= 0 and b.lo >= 0:
        if math.isfinite(a.hi) and math.isfinite(b.hi):
            hi = min(a.hi + b.hi, _next_pow2_minus1(max(a.hi, b.hi)))
        else:
            hi = _INF
        lo = 0.0 if is_xor else max(a.lo, b.lo)
        return Interval(lo, hi, int_valued=True, reduced=a.reduced or b.reduced)
    return Interval(-_INF, _INF, int_valued=a.int_valued and b.int_valued)


def monotone_unary(a: Interval, f: Any, int_valued: bool = False) -> Interval:
    """``f`` over an interval, ``f`` monotone (either way)."""
    def apply(v: float) -> float:
        if not math.isfinite(v):
            try:
                return f(v)
            except (OverflowError, ValueError):
                return v if v > 0 else f(-1e308)
        try:
            return f(v)
        except OverflowError:
            return _INF

    lo, hi = apply(a.lo), apply(a.hi)
    if math.isnan(lo) or math.isnan(hi):
        return Interval(-_INF, _INF, reduced=a.reduced)
    return Interval(min(lo, hi), max(lo, hi), int_valued=int_valued, reduced=a.reduced)
