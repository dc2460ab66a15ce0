"""Interval abstract interpretation of aten graphs (the overflow and gather passes).

Counterpart of ``repro/analysis/interp.py``, which walks jaxprs; this
walks the ``torch.fx`` graph of a fake-traced body (``analysis.spec``)
with every value summarized by an :class:`~repro_torch.analysis.domain.Interval`:
O(1) work per node whatever the tensor shapes.  Three families of checks
fire as nodes are interpreted:

* **carrier overflow**: an integer-dtype result whose mathematical
  envelope leaves its carrier.  Bitwise ops and signed left shifts are
  defined-modular lane surgery and exempt; every other wrap, a
  conversion into a narrower integer included, is a finding.  Output
  contracts (:func:`check_output_contract`) extend this to claims that
  bind before any carrier wraps: the packed product tops out at
  ``2^{2n} - 1`` but its int32-payload contract breaks at n = 16.
* **exactness**: an integer-valued float (float32: past 2^24; bfloat16:
  past 2^8) whose *pre-reduction* magnitude can exceed its dtype's exact
  range cannot hold every integer it may take.  Accumulators scale with
  K and are reported as a derived ``k_exact`` instead.
* **gather bounds**: every ``index`` / ``index_select`` / ``gather`` /
  ``embedding`` index interval must lie inside its table's extent.  The
  online-softmax probabilities are proven in ``[0, 1]`` by dominance
  (``amax`` / ``maximum`` results dominate their operands;
  ``exp(x - m) <= 1`` when ``m`` dominates ``x``), which closes the
  attention's ``U[p_int]`` and table gathers.

An aten op with no transfer function is a gating ``unmodelled-op``
finding, never a silent top: the proof would not cover the body.
In-place ops write their result into the written node and join it into
the node it is a view of; an ``empty`` tensor is uninitialized until
written, as the reference's kernel refs are.
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any, Callable

import torch

from repro_torch.analysis import domain
from repro_torch.analysis.domain import Interval, exact_int_limit, is_integer_dtype
from repro_torch.analysis.spec import TraceSpec

__all__ = [
    "GATING_KINDS", "AuditPolicy", "Finding", "InterpReport", "Interpreter",
    "check_output_contract", "interpret",
]

_INF = math.inf

# Finding kinds that block certification; "note" is informational.
GATING_KINDS = frozenset({
    "overflow", "exactness", "gather", "unmodelled-op", "smem-budget", "registers",
    "threads", "tile", "trace-rejected", "contract", "input-carrier", "dispatch-contract",
})

# float arithmetic whose mathematical result may not be representable;
# rounding, clamping, selection and structural ops only repeat values
_EXACTNESS_OPS = frozenset({"add", "sub", "rsub", "mul", "mm", "bmm", "addmm", "baddbmm",
                            "dot", "mv", "pow", "square"})


@dataclasses.dataclass(frozen=True)
class Finding:
    kind: str
    message: str
    where: str = ""

    @property
    def gating(self) -> bool:
        return self.kind in GATING_KINDS


@dataclasses.dataclass(frozen=True)
class AuditPolicy:
    # Gate unreduced integer-valued floats past their exact range (the
    # bit-exact parity contract).  Off for float-valued modes.
    exact_products: bool = True


@dataclasses.dataclass
class InterpReport:
    findings: list[Finding]
    facts: dict[str, Any]

    @property
    def gating_findings(self) -> list[Finding]:
        return [f for f in self.findings if f.gating]

    @property
    def certified(self) -> bool:
        return not self.gating_findings


_UNINIT = object()  # an ``empty`` tensor before its first write


def _const_interval(c: torch.Tensor) -> Interval:
    """The envelope of a real constant tensor (a table, a factor)."""
    if c.numel() == 0:
        return Interval.point(0.0)
    if c.dtype == torch.uint16 or c.dtype == torch.uint32:
        c = c.to(torch.int64)
    if c.dtype == torch.bool:
        c = c.to(torch.int8)
    lo, hi = float(c.min()), float(c.max())
    int_valued = is_integer_dtype(c.dtype)
    if not int_valued and math.isfinite(lo) and math.isfinite(hi):
        # integrality past the exact range is vacuous for floats, and would
        # make mask sentinels look like wide-integer arithmetic
        int_valued = bool(torch.all(torch.remainder(c.double(), 1.0) == 0)) and \
            max(abs(lo), abs(hi)) <= exact_int_limit(c.dtype)
    return Interval(lo, hi, int_valued=int_valued)


def _clamp_to(iv: Interval, dtype: Any) -> Interval:
    full = Interval.of_dtype(dtype)
    lo, hi = max(iv.lo, full.lo), min(iv.hi, full.hi)
    if lo > hi:  # entirely out of the carrier: wraps to anything
        return full
    return Interval(lo, hi, int_valued=True, reduced=iv.reduced, dominates=iv.dominates)


def _point_exact(iv: Interval, dtype: torch.dtype) -> bool:
    """A point whose single value round-trips through ``dtype`` is exactly
    representable however large (a mask fill, an integral literal)."""
    if not iv.is_point:
        return False
    return float(torch.tensor(iv.lo, dtype=torch.float64).to(dtype).double()) == iv.lo


def _dtype_of(node: Any) -> Any:
    val = node.meta.get("val") if hasattr(node, "meta") else None
    return getattr(val, "dtype", None)


def _shape_of(node: Any) -> tuple:
    val = node.meta.get("val")
    return tuple(int(d) for d in val.shape)


def _name(node: Any) -> str:
    target = node.target
    if target is operator.getitem:
        return "getitem"
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


class Interpreter:
    """Walks one fx graph; ``findings`` and ``facts`` accumulate."""

    def __init__(self, policy: AuditPolicy, where: str = ""):
        self.policy = policy
        self.where = where
        self.findings: list[Finding] = []
        self.facts: dict[str, Any] = {
            "gathers_checked": 0,
            "gathers_proven": 0,
            "k_exact": None,
            "max_unreduced_int_f32": 0.0,
            "carrier_peaks": {},
            "nodes": 0,
        }
        self.env: dict = {}
        self.base: dict = {}  # view node -> the node whose storage it views

    # -- bookkeeping -------------------------------------------------
    def finding(self, kind: str, message: str, node: Any = None) -> None:
        where = f"{self.where}:{node.name}" if node is not None else self.where
        self.findings.append(Finding(kind, message, where))

    def note_k_exact(self, per_term: float, dtype: Any) -> None:
        limit = exact_int_limit(dtype)
        if per_term <= 0 or not math.isfinite(per_term) or not math.isfinite(limit):
            return
        k = int(limit // max(1.0, per_term))
        prev = self.facts["k_exact"]
        self.facts["k_exact"] = k if prev is None else min(prev, k)

    # -- values ------------------------------------------------------
    def val(self, a: Any) -> Any:
        if isinstance(a, torch.fx.Node):
            v = self.env[a]
            return Interval.of_dtype(_dtype_of(a)) if v is _UNINIT else v
        if isinstance(a, bool):
            return Interval.point(float(a), True)
        if isinstance(a, (int, float)):
            return Interval.point(float(a))
        if isinstance(a, (list, tuple)):
            return [self.val(x) for x in a]
        return a

    def land(self, node: Any, iv: Any, name: str) -> None:
        """Bind a node's result, running the overflow and exactness checks."""
        dtype = _dtype_of(node)
        if not isinstance(iv, Interval) or dtype is None:
            self.env[node] = iv
            return
        if is_integer_dtype(dtype) and dtype != torch.bool:
            if not iv.fits(dtype):
                exempt = name in ("bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
                                  "__and__", "__or__", "__xor__", "view") or (
                    name in ("__lshift__", "bitwise_left_shift") and dtype.is_signed)
                if not exempt:
                    self.finding("overflow",
                                 f"{name}: envelope [{iv.lo:.6g}, {iv.hi:.6g}] leaves the "
                                 f"{str(dtype).replace('torch.', '')} carrier", node)
                iv = _clamp_to(iv, dtype)
            key = str(dtype).replace("torch.", "")
            peaks = self.facts["carrier_peaks"]
            peaks[key] = max(peaks.get(key, 0.0), iv.magnitude())
        elif dtype.is_floating_point and iv.int_valued and not iv.reduced:
            mag = iv.magnitude()
            if dtype == torch.float32 and math.isfinite(mag):
                self.facts["max_unreduced_int_f32"] = max(
                    self.facts["max_unreduced_int_f32"], mag)
            if (name in _EXACTNESS_OPS and self.policy.exact_products
                    and mag > exact_int_limit(dtype) and not _point_exact(iv, dtype)):
                self.finding("exactness",
                             f"{name}: integer-valued {str(dtype).replace('torch.', '')} "
                             f"envelope [{iv.lo:.6g}, {iv.hi:.6g}] exceeds its exact range "
                             f"2^{int(math.log2(exact_int_limit(dtype)))} before any "
                             f"reduction", node)
                iv = iv.with_(int_valued=False)
        self.env[node] = iv

    # -- the walk ----------------------------------------------------
    def run(self, gm: torch.fx.GraphModule, args: list[Interval]) -> list[Any]:
        inputs = iter(args)
        outs: list[Any] = []
        for node in gm.graph.nodes:
            self.facts["nodes"] += 1
            if node.op == "placeholder":
                self.env[node] = next(inputs)
            elif node.op == "get_attr":
                self.env[node] = _const_interval(getattr(gm, node.target))
            elif node.op == "call_function":
                self.call(node)
            elif node.op == "output":
                res = node.args[0]
                res = res if isinstance(res, (list, tuple)) else [res]
                outs = [self.val(r) if isinstance(r, torch.fx.Node) else r for r in res]
            else:
                self.finding("unmodelled-op", f"graph node kind {node.op!r}", node)
                self.env[node] = Interval.of_dtype(_dtype_of(node))
        return outs

    def call(self, node: Any) -> None:
        name = _name(node)
        inplace = (name.endswith("_") and not name.endswith("__") and name[:-1] in _HANDLERS)
        handler = _HANDLERS.get(name[:-1] if inplace else name)
        if handler is None:
            self.finding("unmodelled-op",
                         f"aten op {node.target} has no transfer function in the certifier",
                         node)
            val = node.meta.get("val")
            if isinstance(val, (list, tuple)):
                self.env[node] = [Interval.of_dtype(getattr(v, "dtype", None)) for v in val]
            else:
                self.env[node] = Interval.of_dtype(_dtype_of(node))
            return
        handler(self, node, name[:-1] if inplace else name)
        if inplace and node.args and isinstance(node.args[0], torch.fx.Node):
            self.write(node.args[0], self.env[node])

    def write(self, target: Any, iv: Any) -> None:
        """``target`` now holds ``iv``; the tensor it views holds old or new."""
        self.env[target] = iv
        base = self.base.get(target)
        if base is not None and base is not target:
            old = self.env.get(base)
            self.env[base] = iv if old is _UNINIT or old is None else old.join(iv)

    def alias(self, node: Any, of: Any) -> None:
        if isinstance(of, torch.fx.Node):
            self.base[node] = self.base.get(of, of)


def check_output_contract(spec: TraceSpec, outs: list[Any]) -> list[Finding]:
    """Traced output envelopes against the spec's ``out_ranges``: an
    envelope that can leave its caller-facing contract gates even when no
    carrier wraps (how the packed ``2n <= 31`` bound is rediscovered)."""
    findings: list[Finding] = []
    for i, (out, rng) in enumerate(zip(outs, spec.out_ranges)):
        if rng is None or not isinstance(out, Interval):
            continue
        if out.lo < rng.lo or out.hi > rng.hi:
            why = f" ({spec.out_contract_reason})" if spec.out_contract_reason else ""
            findings.append(Finding(
                "contract",
                f"output {i} envelope [{out.lo:.6g}, {out.hi:.6g}] can leave its declared "
                f"contract [{rng.lo:.6g}, {rng.hi:.6g}]{why}", spec.name))
    return findings


def check_input_carriers(spec: TraceSpec) -> list[Finding]:
    """Each input's contract must fit the carrier it arrives in: an n-bit
    magnitude plane in int16 holds n <= 15 only."""
    findings = []
    for i, (arg, rng) in enumerate(zip(spec.args, spec.input_ranges())):
        dtype = getattr(arg, "dtype", None)
        if dtype is not None and is_integer_dtype(dtype) and not Interval(
                rng.lo, rng.hi).fits(dtype):
            findings.append(Finding(
                "input-carrier", f"input {i} contract [{rng.lo:.6g}, {rng.hi:.6g}] does not fit "
                f"its {str(dtype).replace('torch.', '')} carrier", spec.name))
    return findings


def interpret(spec: TraceSpec, policy: AuditPolicy | None = None,
              gm: torch.fx.GraphModule | None = None) -> tuple[InterpReport, list[Any]]:
    """Trace ``spec`` (unless ``gm`` is its trace) and interpret it under its
    contract; returns the report and the output envelopes."""
    policy = policy or AuditPolicy(exact_products=spec.exact_products)
    gm = spec.trace() if gm is None else gm
    it = Interpreter(policy, spec.name)
    args = [Interval(r.lo, r.hi, int_valued=r.int_valued) for r in spec.input_ranges()]
    outs = it.run(gm, args)
    findings = check_input_carriers(spec) + it.findings + check_output_contract(spec, outs)
    return InterpReport(findings=findings, facts=it.facts), outs


# ---------------------------------------------------------------------
# transfer functions, one per aten op (overload packet)
# ---------------------------------------------------------------------

_HANDLERS: dict[str, Callable[[Interpreter, Any, str], None]] = {}


def _register(*names: str):
    def deco(fn):
        for n in names:
            _HANDLERS[n] = fn
        return fn
    return deco


def _arg(node: Any, i: int, key: str, default: Any = None) -> Any:
    if len(node.args) > i:
        return node.args[i]
    return node.kwargs.get(key, default)


@_register("view", "_unsafe_view", "reshape", "expand", "unsqueeze", "squeeze", "clone",
           "detach", "alias", "contiguous", "flatten", "_reshape_alias", "lift_fresh_copy",
           "lift_fresh", "expand_as", "view_as", "dropout", "_assert_tensor_metadata")
def _identity(self, node, name):
    a = self.val(node.args[0])
    self.land(node, a, name)
    if name not in ("clone", "lift_fresh_copy", "contiguous", "dropout"):
        self.alias(node, node.args[0])


@_register("permute", "transpose", "t", "slice", "select", "narrow", "flip", "roll", "repeat",
           "as_strided", "diagonal", "unfold", "movedim", "numpy_T", "tile", "repeat_interleave")
def _permute(self, node, name):
    a = self.val(node.args[0])
    self.land(node, a.with_(dominates=frozenset()), name)
    if name not in ("flip", "roll", "repeat", "tile", "repeat_interleave"):
        self.alias(node, node.args[0])


@_register("split", "split_with_sizes", "unbind", "chunk", "tensor_split")
def _split(self, node, name):
    a = self.val(node.args[0]).with_(dominates=frozenset())
    self.env[node] = [a for _ in node.meta["val"]]


@_register("getitem")
def _getitem(self, node, name):
    src = self.env[node.args[0]]
    self.env[node] = src[node.args[1]] if isinstance(src, (list, tuple)) else src


@_register("cat", "stack", "concat", "hstack", "vstack")
def _cat(self, node, name):
    ivs = [iv for iv in self.val(node.args[0])]
    self.land(node, domain.join_all(ivs).with_(dominates=frozenset()), name)


@_register("constant_pad_nd")
def _pad(self, node, name):
    a = self.val(node.args[0])
    value = _arg(node, 2, "value", 0)
    self.land(node, a.join(Interval.point(float(value))), name)


@_register("zeros", "ones", "full", "scalar_tensor", "zeros_like", "ones_like", "full_like",
           "new_zeros", "new_ones", "new_full", "fill")
def _filled(self, node, name):
    if name in ("zeros", "zeros_like", "new_zeros"):
        v = 0.0
    elif name in ("ones", "ones_like", "new_ones"):
        v = 1.0
    elif name == "scalar_tensor":
        v = float(node.args[0])
    elif name == "new_full":  # (self, size, fill_value)
        v = float(node.args[2])
    else:  # full (size, value), full_like and fill (self, value)
        v = float(node.args[1])
    iv = Interval.point(v)
    dtype = _dtype_of(node)
    if dtype is not None and is_integer_dtype(dtype):
        iv = iv.with_(int_valued=True)
    self.land(node, iv, name)


@_register("empty", "empty_like", "new_empty", "empty_strided", "empty_permuted")
def _empty(self, node, name):
    self.env[node] = _UNINIT


@_register("arange")
def _arange(self, node, name):
    args = [float(a) for a in node.args if isinstance(a, (int, float))]
    start, end, step = (0.0, args[0], 1.0) if len(args) == 1 else (
        args[0], args[1], args[2] if len(args) > 2 else 1.0)
    n = max(0, math.ceil((end - start) / step))
    last = start + step * max(0, n - 1)
    self.land(node, Interval(min(start, last), max(start, last),
                             int_valued=all(float(a).is_integer() for a in args)), name)


@_register("rand", "randn", "rand_like", "randn_like", "normal", "randint", "uniform",
           "bernoulli")
def _random(self, node, name):
    if name in ("rand", "rand_like", "uniform", "bernoulli"):
        iv = Interval(0.0, 1.0, int_valued=name == "bernoulli")
    elif name == "randint":  # (high, size) or (low, high, size)
        low_high = len(node.args) > 2 and isinstance(node.args[1], int)
        lo, hi = (float(node.args[0]), float(node.args[1])) if low_high else (
            0.0, float(node.args[0]))
        iv = Interval(min(lo, hi - 1), hi - 1, int_valued=True)
    else:
        iv = Interval.of_dtype(_dtype_of(node))
    self.land(node, iv, name)


def _scaled(b: Interval, alpha: Any) -> Interval:
    if alpha is None or alpha == 1:
        return b
    return domain.mul(b, Interval.point(float(alpha)))


@_register("add")
def _add(self, node, name):
    a, b = self.val(node.args[0]), self.val(node.args[1])
    self.land(node, domain.add(a, _scaled(b, node.kwargs.get("alpha"))), name)


@_register("sub", "rsub")
def _sub(self, node, name):
    a, b = self.val(node.args[0]), _scaled(self.val(node.args[1]), node.kwargs.get("alpha"))
    x_node, m = node.args[0], b
    if name == "rsub":
        a, b = b, a
        x_node, m = node.args[1], b
    out = domain.sub(a, b)
    # dominance refinement: a running max over x bounds x - max from above
    if name == "sub" and isinstance(x_node, torch.fx.Node) and x_node in m.dominates:
        out = Interval(min(out.lo, 0.0), min(out.hi, 0.0), int_valued=out.int_valued,
                       reduced=out.reduced)
    self.land(node, out, name)


@_register("mul", "square")
def _mul(self, node, name):
    a = self.val(node.args[0])
    b = a if name == "square" else self.val(node.args[1])
    out = domain.mul(a, b)
    if name == "square" or (len(node.args) > 1 and node.args[0] is node.args[1]):
        out = Interval(max(out.lo, 0.0), out.hi, int_valued=out.int_valued,
                       reduced=out.reduced)
    self.land(node, out, name)


@_register("div", "floor_divide", "true_divide")
def _div(self, node, name):
    a, b = self.val(node.args[0]), self.val(node.args[1])
    out = domain.div(a, b)
    mode = node.kwargs.get("rounding_mode", "floor" if name == "floor_divide" else None)
    if mode in ("floor", "trunc") and math.isfinite(out.lo) and math.isfinite(out.hi):
        out = Interval(math.floor(out.lo), math.ceil(out.hi), int_valued=True,
                       reduced=out.reduced)
    elif mode in ("floor", "trunc"):
        out = out.with_(int_valued=True)
    self.land(node, out, name)


@_register("reciprocal")
def _reciprocal(self, node, name):
    self.land(node, domain.div(Interval.point(1.0), self.val(node.args[0])), name)


@_register("remainder", "fmod")
def _rem(self, node, name):
    a, b = self.val(node.args[0]), self.val(node.args[1])
    m = b.magnitude()
    iv = (Interval(0.0, min(a.hi, m), int_valued=a.int_valued and b.int_valued)
          if a.lo >= 0 and b.lo > 0 else
          Interval(0.0, m, int_valued=a.int_valued and b.int_valued)
          if name == "remainder" and b.lo > 0 else
          Interval(-m, m, int_valued=a.int_valued and b.int_valued))
    self.land(node, iv, name)


@_register("maximum", "fmax")
def _maximum(self, node, name):
    a, b = self.val(node.args[0]), self.val(node.args[1])
    dominated = frozenset(x for x in node.args[:2] if isinstance(x, torch.fx.Node))
    self.land(node, domain.max_(a, b, dominated), name)


@_register("minimum", "fmin")
def _minimum(self, node, name):
    self.land(node, domain.min_(self.val(node.args[0]), self.val(node.args[1])), name)


@_register("neg")
def _neg(self, node, name):
    a = self.val(node.args[0])
    self.land(node, Interval(-a.hi, -a.lo, int_valued=a.int_valued, reduced=a.reduced), name)


@_register("abs")
def _abs(self, node, name):
    a = self.val(node.args[0])
    if a.lo >= 0:
        out = a.with_(dominates=frozenset())
    elif a.hi <= 0:
        out = Interval(-a.hi, -a.lo, int_valued=a.int_valued, reduced=a.reduced)
    else:
        out = Interval(0.0, a.magnitude(), int_valued=a.int_valued, reduced=a.reduced)
    self.land(node, out, name)


@_register("sign", "sgn")
def _sign(self, node, name):
    a = self.val(node.args[0])
    lo = -1.0 if a.lo < 0 else 0.0 if a.lo == 0 else 1.0
    hi = 1.0 if a.hi > 0 else 0.0 if a.hi == 0 else -1.0
    self.land(node, Interval(lo, hi, int_valued=True), name)


@_register("floor", "ceil", "round", "trunc")
def _round(self, node, name):
    a = self.val(node.args[0])
    lo = math.floor(a.lo) if math.isfinite(a.lo) else a.lo
    hi = math.ceil(a.hi) if math.isfinite(a.hi) else a.hi
    decimals = node.kwargs.get("decimals", 0)
    self.land(node, Interval(lo, hi, int_valued=not decimals, reduced=a.reduced), name)


@_register("clamp", "clamp_min", "clamp_max", "clip")
def _clamp(self, node, name):
    x = self.val(node.args[0])
    lo_a = _arg(node, 1, "min") if name in ("clamp", "clip", "clamp_min") else None
    hi_a = (_arg(node, 2, "max") if name in ("clamp", "clip") else
            _arg(node, 1, "max") if name == "clamp_max" else None)
    lo_iv = self.val(lo_a) if lo_a is not None else None
    hi_iv = self.val(hi_a) if hi_a is not None else None
    lo = max(x.lo, lo_iv.lo) if lo_iv is not None else x.lo
    hi = min(x.hi, hi_iv.hi) if hi_iv is not None else x.hi
    if lo_iv is not None:
        hi = max(hi, lo_iv.lo)  # clamp(x, a, b) >= a even where x < a
    if hi_iv is not None:
        lo = min(lo, hi_iv.hi)
    if lo > hi:
        lo, hi = hi, lo
    int_valued = x.int_valued and all(b is None or b.int_valued for b in (lo_iv, hi_iv))
    self.land(node, Interval(lo, hi, int_valued=int_valued, reduced=x.reduced), name)


@_register("pow")
def _pow(self, node, name):
    a, y = self.val(node.args[0]), node.args[1]
    if not isinstance(y, (int, float)) or not float(y).is_integer() or y < 0:
        self.land(node, Interval.of_dtype(_dtype_of(node)) if a.lo < 0 else
                  domain.monotone_unary(a, lambda v: v ** y if v >= 0 else 0.0), name)
        return
    y = int(y)
    cands = [a.lo ** y, a.hi ** y]
    if y % 2 == 0 and a.lo < 0 < a.hi:
        cands.append(0.0)
    self.land(node, Interval(min(cands), max(cands), int_valued=a.int_valued,
                             reduced=a.reduced), name)


def _monotone(fn, int_valued=False):
    def handler(self, node, name):
        self.land(node, domain.monotone_unary(self.val(node.args[0]), fn, int_valued), name)
    return handler


def _sigmoid(v: float) -> float:
    return 1.0 / (1.0 + math.exp(-max(min(v, 700.0), -700.0)))


_register("exp")(_monotone(lambda v: math.exp(min(v, 710.0)) if v < 710 else _INF))
_register("exp2")(_monotone(lambda v: 2.0 ** v if v < 1024 else _INF))
_register("log")(_monotone(lambda v: math.log(v) if v > 0 else -_INF))
_register("log2")(_monotone(lambda v: math.log2(v) if v > 0 else -_INF))
_register("log1p")(_monotone(lambda v: math.log1p(v) if v > -1 else -_INF))
_register("expm1")(_monotone(lambda v: math.expm1(min(v, 709.0)) if v < 709 else _INF))
_register("tanh")(_monotone(math.tanh))
_register("sigmoid")(_monotone(_sigmoid))
_register("erf")(_monotone(math.erf))
_register("sqrt")(_monotone(lambda v: math.sqrt(v) if v >= 0 else 0.0))
_register("rsqrt")(_monotone(lambda v: 1.0 / math.sqrt(v) if v > 0 else _INF))
_register("relu")(_monotone(lambda v: max(v, 0.0)))
_register("softplus")(_monotone(lambda v: math.log1p(math.exp(min(v, 700.0))) if v < 700 else v))


@_register("sin", "cos")
def _trig(self, node, name):
    self.land(node, Interval(-1.0, 1.0), name)


@_register("silu", "gelu")
def _swish(self, node, name):
    a = self.val(node.args[0])
    floor = -0.2785 if name == "silu" else -0.1701
    hi = a.hi if a.hi > 0 else 0.0
    hi = hi if math.isfinite(hi) else _INF
    self.land(node, Interval(floor, max(hi, 0.0), reduced=a.reduced), name)


@_register("_softmax", "softmax")
def _softmax(self, node, name):
    self.land(node, Interval(0.0, 1.0), name)


@_register("_log_softmax", "log_softmax")
def _log_softmax(self, node, name):
    self.land(node, Interval(-_INF, 0.0), name)


@_register("__lshift__", "bitwise_left_shift")
def _shl(self, node, name):
    self.land(node, domain.shift_left(self.val(node.args[0]), self.val(node.args[1])), name)


@_register("__rshift__", "bitwise_right_shift")
def _shr(self, node, name):
    self.land(node, domain.shift_right(self.val(node.args[0]), self.val(node.args[1])), name)


def _is_bool(node: Any) -> bool:
    return _dtype_of(node) == torch.bool


@_register("bitwise_and", "__and__", "logical_and")
def _and(self, node, name):
    a, b = self.val(node.args[0]), self.val(node.args[1])
    if _is_bool(node):
        out = (Interval.point(float(bool(a.lo) and bool(b.lo))) if a.is_point and b.is_point
               else Interval.point(0.0) if (a.is_point and a.lo == 0) or (b.is_point and b.lo == 0)
               else Interval.bool01())
    else:
        out = domain.bit_and(a, b)
    self.land(node, out, name)


@_register("bitwise_or", "bitwise_xor", "__or__", "__xor__", "logical_or", "logical_xor")
def _or(self, node, name):
    a, b = self.val(node.args[0]), self.val(node.args[1])
    xor = "xor" in name
    if _is_bool(node):
        out = Interval.bool01()
        if a.is_point and b.is_point:
            av, bv = bool(a.lo), bool(b.lo)
            out = Interval.point(float(av != bv if xor else av or bv))
    else:
        out = domain.bit_or(a, b, is_xor=xor)
    self.land(node, out, name)


@_register("bitwise_not", "logical_not")
def _not(self, node, name):
    a = self.val(node.args[0])
    if _is_bool(node):
        out = Interval.point(float(not bool(a.lo))) if a.is_point else Interval.bool01()
    else:
        out = Interval(-a.hi - 1, -a.lo - 1, int_valued=True)
    self.land(node, out, name)


def _cmp(certain_true, certain_false):
    def handler(self, node, name):
        a, b = self.val(node.args[0]), self.val(node.args[1])
        out = (Interval.point(1.0) if certain_true(a, b) else
               Interval.point(0.0) if certain_false(a, b) else Interval.bool01())
        self.land(node, out, name)
    return handler


_register("eq")(_cmp(lambda a, b: a.is_point and b.is_point and a.lo == b.lo,
                     lambda a, b: a.hi < b.lo or b.hi < a.lo))
_register("ne")(_cmp(lambda a, b: a.hi < b.lo or b.hi < a.lo,
                     lambda a, b: a.is_point and b.is_point and a.lo == b.lo))
_register("lt")(_cmp(lambda a, b: a.hi < b.lo, lambda a, b: a.lo >= b.hi))
_register("le")(_cmp(lambda a, b: a.hi <= b.lo, lambda a, b: a.lo > b.hi))
_register("gt")(_cmp(lambda a, b: a.lo > b.hi, lambda a, b: a.hi <= b.lo))
_register("ge")(_cmp(lambda a, b: a.lo >= b.hi, lambda a, b: a.hi < b.lo))


@_register("isnan", "isinf", "isfinite", "any", "all")
def _bool_result(self, node, name):
    self.land(node, Interval.bool01(), name)


@_register("where")
def _where(self, node, name):
    cond, a, b = (self.val(x) for x in node.args[:3])
    if cond.is_point:
        out = a if cond.lo else b
    else:
        out = a.join(b)
    self.land(node, out, name)


@_register("masked_fill")
def _masked_fill(self, node, name):
    a, mask, v = (self.val(x) for x in node.args[:3])
    self.land(node, a if mask.is_point and not mask.lo else a.join(v), name)


@_register("_to_copy", "to", "type_as", "_convert_element_type")
def _convert(self, node, name):
    a = self.val(node.args[0])
    new = _dtype_of(node)
    src = _dtype_of(node.args[0]) if isinstance(node.args[0], torch.fx.Node) else None
    out = a
    if new is not None and is_integer_dtype(new) and new != torch.bool:
        if not a.int_valued:  # a float -> int conversion truncates toward zero
            lo = float(math.trunc(a.lo)) if math.isfinite(a.lo) else a.lo
            hi = float(math.trunc(a.hi)) if math.isfinite(a.hi) else a.hi
            out = Interval(lo, hi, int_valued=True, reduced=a.reduced)
        else:
            out = a.with_(int_valued=True, dominates=frozenset())
    elif new == torch.bool:
        out = Interval.bool01() if not a.is_point else Interval.point(float(a.lo != 0))
    elif new is not None and new.is_floating_point:
        limit = exact_int_limit(new)
        if (a.int_valued and not a.reduced and self.policy.exact_products
                and src is not None and src != new and a.magnitude() > limit
                and not _point_exact(a, new)):
            self.finding("exactness",
                         f"{name}: integer envelope [{a.lo:.6g}, {a.hi:.6g}] is not exactly "
                         f"representable in {str(new).replace('torch.', '')} "
                         f"(> 2^{int(math.log2(limit))})", node)
            out = a.with_(int_valued=False, dominates=frozenset())
        elif src is not None and src.is_floating_point and new != src:
            out = a.with_(dominates=frozenset())
    self.land(node, out, name)


@_register("copy")
def _copy(self, node, name):
    src = self.val(node.args[1])
    self.land(node, src.with_(dominates=frozenset()), "_to_copy")


def _numel(shape: tuple, dims: Any) -> int:
    if dims is None or dims == []:
        return max(1, math.prod(shape))
    dims = [dims] if isinstance(dims, int) else dims
    return max(1, math.prod(shape[d] for d in dims))


@_register("sum", "nansum")
def _sum(self, node, name):
    a = self.val(node.args[0])
    n = _numel(_shape_of(node.args[0]), _arg(node, 1, "dim"))
    # a sum is an accumulator whatever its length (a K of 1 included)
    out = Interval(a.lo * n, a.hi * n, int_valued=a.int_valued, reduced=True)
    if n > 1 and a.int_valued and not is_integer_dtype(_dtype_of(node)):
        self.note_k_exact(a.magnitude(), _dtype_of(node))
    self.land(node, out, name)


@_register("mean")
def _mean(self, node, name):
    a = self.val(node.args[0])
    self.land(node, Interval(a.lo, a.hi, reduced=True), name)


@_register("var", "std", "var_mean", "std_mean")
def _var(self, node, name):
    a = self.val(node.args[0])
    spread = a.hi - a.lo
    var = Interval(0.0, spread * spread if math.isfinite(spread) else _INF, reduced=True)
    std = Interval(0.0, spread if math.isfinite(spread) else _INF, reduced=True)
    mean = Interval(a.lo, a.hi, reduced=True)
    if name in ("var_mean", "std_mean"):
        self.env[node] = [var if name == "var_mean" else std, mean]
    else:
        self.land(node, var if name == "var" else std, name)


@_register("amax", "amin", "max", "min")
def _reduce_max(self, node, name):
    a = self.val(node.args[0])
    if len(node.args) > 1 and not isinstance(node.args[1], (int, list, tuple)) and \
            name in ("max", "min"):
        # the elementwise (Tensor, Tensor) overloads
        return (_maximum if name == "max" else _minimum)(self, node, name)
    out = a.with_(dominates=a.dominates | frozenset([node.args[0]])) if name in (
        "amax", "max") else a.with_(dominates=frozenset())
    if isinstance(node.meta.get("val"), (list, tuple)):  # (values, indices)
        n = _shape_of(node.args[0])[node.args[1]]
        self.env[node] = [out, Interval(0.0, float(n - 1), int_valued=True)]
        return
    self.land(node, out, name)


@_register("argmax", "argmin")
def _argmax(self, node, name):
    n = _numel(_shape_of(node.args[0]), _arg(node, 1, "dim"))
    self.land(node, Interval(0.0, float(n - 1), int_valued=True), name)


@_register("cumsum")
def _cumsum(self, node, name):
    a = self.val(node.args[0])
    n = _shape_of(node.args[0])[node.args[1]] if _shape_of(node.args[0]) else 1
    out = Interval(min(a.lo, a.lo * n), max(a.hi, a.hi * n), int_valued=a.int_valued,
                   reduced=a.reduced or n > 1)
    self.land(node, out, name)


@_register("cummax", "cummin")
def _cummax(self, node, name):
    a = self.val(node.args[0])
    n = _shape_of(node.args[0])[node.args[1]]
    self.env[node] = [a.with_(dominates=frozenset()),
                      Interval(0.0, float(n - 1), int_valued=True)]


@_register("sort", "topk")
def _sort(self, node, name):
    a = self.val(node.args[0]).with_(dominates=frozenset())
    shape = _shape_of(node.args[0])
    dim = _arg(node, 2 if name == "topk" else 1, "dim", -1)
    n = shape[dim] if shape else 1
    self.env[node] = [a, Interval(0.0, float(n - 1), int_valued=True)]


@_register("mm", "bmm", "dot", "mv", "addmm", "baddbmm", "addmv")
def _dot(self, node, name):
    bias = None
    args = list(node.args)
    if name in ("addmm", "baddbmm", "addmv"):
        bias, args = self.val(args[0]), args[1:]
    a, b = self.val(args[0]), self.val(args[1])
    k = max(1, _shape_of(args[0])[-1])
    prod = domain.mul(a, b)
    out = Interval(min(prod.lo * k, prod.lo), max(prod.hi * k, prod.hi),
                   int_valued=prod.int_valued, reduced=prod.reduced or k > 1)
    if prod.int_valued and k > 1:
        self.note_k_exact(prod.magnitude(), _dtype_of(node))
    if bias is not None:
        beta, alpha = node.kwargs.get("beta", 1), node.kwargs.get("alpha", 1)
        out = domain.add(_scaled(bias, beta), _scaled(out, alpha))
    self.land(node, out, name)


def _check_index(self, node, idx: Interval, size: int, what: str) -> bool:
    self.facts["gathers_checked"] += 1
    if idx.lo < 0 or idx.hi > size - 1:
        self.finding("gather",
                     f"{what}: index envelope [{idx.lo:.6g}, {idx.hi:.6g}] can leave [0, "
                     f"{size - 1}] of a table dim of {size}", node)
        return False
    self.facts["gathers_proven"] += 1
    return True


@_register("index")
def _index(self, node, name):
    table = self.val(node.args[0])
    shape = _shape_of(node.args[0])
    for d, ix in enumerate(node.args[1]):
        if ix is not None:
            _check_index(self, node, self.val(ix), shape[d], "index")
    self.land(node, table.with_(dominates=frozenset()), name)


@_register("index_select", "gather")
def _index_select(self, node, name):
    table = self.val(node.args[0])
    dim = node.args[1]
    _check_index(self, node, self.val(node.args[2]), _shape_of(node.args[0])[dim], name)
    self.land(node, table.with_(dominates=frozenset()), name)


@_register("embedding")
def _embedding(self, node, name):
    table = self.val(node.args[0])
    _check_index(self, node, self.val(node.args[1]), _shape_of(node.args[0])[0], name)
    self.land(node, table.with_(dominates=frozenset()), name)


@_register("index_put")
def _index_put(self, node, name):
    base, values = self.val(node.args[0]), self.val(node.args[2])
    shape = _shape_of(node.args[0])
    for d, ix in enumerate(node.args[1]):
        if ix is not None and _dtype_of(ix) != torch.bool:
            _check_index(self, node, self.val(ix), shape[d], "index_put")
    accumulate = _arg(node, 3, "accumulate", False)
    self.land(node, domain.add(base, values).join(base) if accumulate else base.join(values),
              name)


@_register("slice_scatter", "select_scatter", "diagonal_scatter", "as_strided_scatter")
def _scatter_view(self, node, name):
    base = self.env[node.args[0]]
    src = self.val(node.args[1])
    self.land(node, src if base is _UNINIT else base.join(src), name)


@_register("_assert_scalar", "_assert_async", "sym_constrain_range_for_size")
def _assert(self, node, name):
    self.env[node] = None


@_register("_local_scalar_dense", "item")
def _item(self, node, name):
    self.env[node] = self.val(node.args[0])


@_register("carrier")
def _carrier(self, node, name):
    """``analysis.carrier``: the value lives in a ``bits``-bit word of a kernel."""
    from repro_torch.analysis.carrier import carrier_range

    a = self.val(node.args[0])
    bits, signed, where = node.args[1:4]
    lo, hi = carrier_range(bits, signed)
    word = f"{'int' if signed else 'uint'}{bits}"
    seen = self.facts.setdefault("carriers", {})
    key = f"{where} ({word})"
    peak = max(seen.get(key, {}).get("peak", 0.0), a.magnitude())
    seen[key] = {"peak": peak, "limit": hi, "headroom_bits": (
        math.log2((hi + 1) / (peak + 1)) if math.isfinite(peak) else -_INF)}
    if a.lo < lo or a.hi > hi:
        self.finding("overflow", f"{where}: envelope [{a.lo:.6g}, {a.hi:.6g}] leaves its "
                     f"{word} carrier [{lo:.6g}, {hi:.6g}]", node)
        a = Interval(max(min(a.lo, hi), lo), min(max(a.hi, lo), hi), int_valued=True,
                     reduced=a.reduced)
    self.land(node, a.with_(dominates=frozenset()), name)
