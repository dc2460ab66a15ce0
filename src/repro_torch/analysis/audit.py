"""Audit orchestration: the mode x tier matrix, verdicts, the gate and the report.

Counterpart of ``repro/analysis/audit.py``.  :func:`audit_matrix` runs the
passes (intervals: overflow and exactness; gather bounds; Hopper's block
budgets, ``analysis.smem``) over every CUDA-backed engine mode at every
tier-resolved split, the approximate attention at every attention split,
the elementwise kernels, the kernel-level contracts, and the frontier
configurations where a bound binds (seqmul's carriers, the packed word's
``2n <= 31``, lowrank attention's shared memory at head width 256).

Each entry is *deployed* (a tier, a model or an entry point uses it) or a
*frontier* entry with the verdict it must get; :func:`report` says
``all_deployed_certified`` and ``frontier_holds``.

Where the port's carriers admit more than the reference's dispatch bound
(seqmul: the reference's n <= 12 comes from its float32 assembly; the
port sums exact integers and its int16 magnitudes hold n <= 15), the
certificate records both, the derived frontier and the dispatch contract
(``engine.dispatch._MODE_MAX_N``), and certifies within both.

:func:`certified` is the cached (mode, n, t) verdict that
``engine.config.resolve_t`` consults; :func:`gate` is the dispatch-time
check behind ``REPRO_STATIC_AUDIT=1``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Any, Optional

from repro_torch.analysis import contracts, smem
from repro_torch.analysis.interp import AuditPolicy, Finding, interpret
from repro_torch.analysis.spec import TraceSpec

__all__ = [
    "AuditResult", "CertificationError", "GATE_CHECKS", "audit_kernel", "audit_matrix",
    "certified", "certified_attention", "certified_elementwise", "certified_flash",
    "certified_kernel", "certified_row", "derived_frontier", "gate", "matrix_entries",
    "report",
    "require_certified",
]

# the (mode, n) bound the reference's dispatch keeps; the port certifies within it
_KIND_OF_MODE = {"bitexact": "lut_gemm", "seqmul": "seqmul_gemm", "inject": "packed_gemm",
                 "lowrank": "lowrank_gemm"}


class CertificationError(ValueError):
    """A kernel was about to run that the static audit did not certify."""


@dataclasses.dataclass
class AuditResult:
    """Outcome of the passes over one traced configuration."""

    name: str
    family: str  # gemm | attention | elementwise | kernel | smem
    mode: str
    n: int
    t: int
    certified: bool
    findings: list[Finding]
    facts: dict[str, Any]
    smem: list[dict]
    deployed: bool = True
    expect: Optional[bool] = None  # a frontier entry's verdict
    error: Optional[str] = None  # trace-time rejection (an eager guard)

    @property
    def as_expected(self) -> bool:
        return self.certified if self.deployed else self.certified == self.expect

    def to_dict(self) -> dict:
        return {
            "name": self.name, "family": self.family, "mode": self.mode, "n": self.n,
            "t": self.t, "certified": self.certified, "deployed": self.deployed,
            "expect": self.expect, "as_expected": self.as_expected,
            "findings": [{"kind": f.kind, "message": f.message, "where": f.where,
                          "gating": f.gating} for f in self.findings],
            "facts": _jsonable(self.facts), "smem": list(self.smem), "error": self.error,
        }


def _jsonable(x: Any) -> Any:
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, float) and (x != x or x in (float("inf"), float("-inf"))):
        return str(x)
    return x


def audit_kernel(spec: TraceSpec, *, family: str = "kernel", mode: str = "", n: int = 0,
                 t: int = 0, footprints: tuple = (), deployed: bool = True,
                 expect: Optional[bool] = None) -> AuditResult:
    """Trace ``spec`` once and run the interval passes; ``footprints`` are
    the blocks (``analysis.smem.Footprint``) its kernels launch.  A trace-
    time exception (an eager guard firing) is itself a static rejection."""
    try:
        gm = spec.trace()
    except Exception as e:  # noqa: BLE001 - guard messages vary by kernel
        return AuditResult(spec.name, family, mode, n, t, False,
                           [Finding("trace-rejected", f"{type(e).__name__}: {e}", spec.name)],
                           {}, [], deployed, expect, str(e))
    rep, _ = interpret(spec, AuditPolicy(exact_products=spec.exact_products), gm)
    findings = list(rep.findings)
    for fp in footprints:
        if not fp.within:
            findings.append(Finding("smem-budget", f"{fp.kernel} ({fp.config}): "
                                    f"{fp.smem_total} bytes of shared memory, {fp.threads} "
                                    f"threads a block, over Hopper's limits", spec.name))
    facts = {**spec.facts, **rep.facts}
    ok = not any(f.gating for f in findings)
    return AuditResult(spec.name, family, mode, n, t, ok, findings, facts,
                       [fp.to_dict() for fp in footprints], deployed, expect)


def _smem_result(name: str, family: str, mode: str, n: int, check, *, deployed: bool = True,
                 expect: Optional[bool] = None, t: int = 0) -> AuditResult:
    """An entry of the shared-memory pass alone: ``check()`` returns the
    footprints or raises ``TileBudgetError``."""
    try:
        fps = check()
    except smem.TileBudgetError as e:
        return AuditResult(name, family, mode, n, t, False, [Finding("smem-budget", str(e), name)],
                           {}, [], deployed, expect)
    bad = [fp for fp in fps if not fp.within]
    findings = [Finding("smem-budget", f"{fp.kernel} ({fp.config}) over Hopper's limits", name)
                for fp in bad]
    return AuditResult(name, family, mode, n, t, not bad, findings, {},
                       [fp.to_dict() for fp in fps], deployed, expect)


# ------------------------------------------------------------- the matrix
def _gemm_footprints(mode: str, n: int, rank: int = 8) -> tuple:
    mod = smem._gemm_module(mode)
    return tuple(smem.gemm_footprint(mode, n, tile, rank) for tile in mod.TILES)


def _dispatch_contract(mode: str) -> Optional[int]:
    from repro_torch.engine.dispatch import _MODE_MAX_N

    return _MODE_MAX_N.get(mode)


@functools.lru_cache(maxsize=None)
def derived_frontier(mode: str) -> Optional[int]:
    """The widest n at which ``mode``'s kernel-level carriers certify (at the
    split n // 2), searched upward from 1 to 16; ``None`` for a mode
    without a kernel."""
    kind = _KIND_OF_MODE.get(mode)
    if kind is None:
        return None
    best = 0
    for n in range(1, 17):
        t = max(1, n // 2)
        if not audit_kernel(contracts.kernel_trace(kind, n, t)).certified:
            break
        best = n
    return best


def _audit_gemm(mode: str, n: int, t: int, *, deployed: bool = True,
                expect: Optional[bool] = None) -> AuditResult:
    spec = contracts.gemm_trace(mode, n, t)
    try:
        fps = _gemm_footprints(mode, n)
    except ValueError:  # a table that cannot be built at this n
        fps = ()
    res = audit_kernel(spec, family="gemm", mode=mode, n=n, t=t, footprints=fps,
                       deployed=deployed, expect=expect)
    contract = _dispatch_contract(mode)
    if contract is not None:
        res.facts["dispatch_contract_n"] = contract
        if n > contract:
            res.facts["derived_frontier_n"] = derived_frontier(mode)
            res.findings.append(Finding(
                "dispatch-contract",
                f"n={n} is past the dispatch contract n <= {contract} of mode {mode!r} "
                f"(engine.dispatch._MODE_MAX_N, the reference's bound); the port's carriers "
                f"alone admit n <= {res.facts['derived_frontier_n']}", spec.name))
            res.certified = False
    return res


def _tier_splits(n: int, target: Optional[str] = None) -> list[int]:
    from repro_torch.engine import config as engine_config

    ts = set()
    for name in engine_config.list_tiers():
        for tgt, budget in engine_config.get_tier(name).budgets:
            if target is None or tgt == target:
                ts.add(engine_config.resolve_t(n, budget).t)
    return sorted(ts)


def _model_head_dims() -> list[int]:
    from repro_torch.configs.registry import get_config, list_archs

    return sorted({get_config(a).head_dim for a in list_archs() if get_config(a).num_heads})


def matrix_entries() -> list[tuple]:
    """``(family, mode, n, t, deployed, expect)``: every CUDA GEMM mode at
    every tier-resolved split; the integer modes' row-parallel routes over
    four K shards (``"gemm_row"``, mode ``"<mode>/<shards>"``); the approximate attention at every attention
    split; the elementwise kernels; the kernel-level contracts; the blocks
    of every GEMM tile and every attention kernel at the models' head
    widths (``smem``, ``t`` the head width); and the frontier entries."""
    from repro_torch.engine import config as engine_config
    from repro_torch.engine import modes as engine_modes

    n = engine_config.DEFAULT_N
    t_def = engine_config.default_t(n)
    out: list[tuple] = []
    for mode in engine_modes.list_modes():
        if engine_modes.get_mode(mode).cuda is not None:
            out += [("gemm", mode, n, t, True, None) for t in _tier_splits(n)]
    out += [("gemm", "seqmul", 12, 6, True, None), ("gemm", "seqmul", 4, 2, True, None),
            ("gemm", "seqmul", 13, 6, False, False)]
    for t in _tier_splits(n, "attn"):
        out += [("attention", mode, n, t, True, None) for mode in ("bitexact", "lowrank")]
    out += [("elementwise", "packed_single", n, t_def, True, None),
            ("elementwise", "packed_single", 12, 6, True, None),
            ("elementwise", "packed_single", 15, 7, False, True),
            ("elementwise", "packed_single", 16, 8, False, False),
            ("elementwise", "packed_words", 16, 8, True, None)]
    out += [("kernel", kind, n, t_def, True, None)
            for kind in ("lut_gemm", "packed_gemm", "lowrank_gemm", "lut_gemm_int",
                         "packed_gemm_int")]
    out += [("kernel", "seqmul_gemm_int", 12, 6, True, None)]
    # the row-parallel routes (tensor parallelism) over four K shards
    out += [("gemm_row", f"{mode}/4", n, t_def, True, None)
            for mode in ("bitexact", "seqmul", "inject")]
    out += [("kernel", "seqmul_gemm", 12, 6, True, None),
            ("kernel", "seqmul_gemm", 15, 7, False, True),
            ("kernel", "seqmul_gemm", 16, 8, False, False),
            ("kernel", "packed_gemm", 15, 7, False, True),
            ("kernel", "packed_gemm", 16, 8, False, False),
            ("kernel", "lut_gemm", 9, 4, False, False)]
    for hd in _model_head_dims():
        out += [("smem", "flash", 0, hd, True, None)]
        out += [("smem", f"approx_{mode}", n, hd, True, None) for mode in ("bitexact", "lowrank")]
    out += [("smem", "gemm_tiles", n, 0, True, None), ("smem", "gemm_tiles", 12, 0, True, None),
            ("smem", "approx_lowrank_r24", n, 256, False, False)]
    return out


def _flash_footprints(hd: int) -> list:
    import torch

    return [fp for dt in (torch.bfloat16, torch.float32)
            for fp in smem.attention_footprints(hd, dt)]


def _audit_entry(family: str, mode: str, n: int, t: int, deployed: bool,
                 expect: Optional[bool]) -> AuditResult:
    kw = dict(deployed=deployed, expect=expect)
    if family == "gemm":
        return _audit_gemm(mode, n, t, **kw)
    if family == "gemm_row":
        gmode, shards = mode.split("/")
        return audit_kernel(contracts.gemm_trace(gmode, n, t, shards=int(shards)),
                            family="gemm", mode=gmode, n=n, t=t, **kw)
    if family == "attention":
        return audit_kernel(contracts.attention_trace(mode, n, t), family=family, mode=mode,
                            n=n, t=t, footprints=(smem.validate_attention(mode, n, 64, 8),), **kw)
    if family in ("elementwise", "kernel"):
        return audit_kernel(contracts.kernel_trace(mode, n, t), family=family, mode=mode, n=n,
                            t=t, **kw)
    hd = t
    if mode == "flash":
        return _smem_result(f"smem:flash_attention[hd={hd}]", family, mode, n,
                            lambda: _flash_footprints(hd), t=hd, **kw)
    if mode.startswith("approx_"):
        amode, rank = ("lowrank", 24) if mode.endswith("_r24") else (mode[7:], 8)
        return _smem_result(f"smem:approx_attention_{amode}[n={n},hd={hd},rank={rank}]", family,
                            mode, n, lambda: [smem.validate_attention(amode, n, hd, rank)],
                            t=hd, **kw)
    modes = ("bitexact", "lowrank", "inject", "seqmul") if n <= 8 else ("seqmul",)
    return _smem_result(f"smem:gemm_tiles[n={n}]", family, mode, n, lambda: [
        smem.validate_tiles(m, n, 0, tile) for m in modes
        for tile in smem._gemm_module(m).TILES], **kw)


def audit_matrix() -> list[AuditResult]:
    """Every matrix entry through its passes."""
    return [_audit_entry(*e) for e in matrix_entries()]


def report(results: Optional[list] = None) -> dict:
    """The machine-readable report (the CLI's ``--report`` payload)."""
    results = audit_matrix() if results is None else results
    return {
        "smem_per_block_bytes": smem.SMEM_PER_BLOCK,
        "regs_per_sm": smem.REGS_PER_SM,
        "all_deployed_certified": all(r.certified for r in results if r.deployed),
        "frontier_holds": all(r.as_expected for r in results if not r.deployed),
        "entries": [r.to_dict() for r in results],
    }


# ------------------------------------------------------ cached verdicts
@functools.lru_cache(maxsize=4096)
def certified(mode: str, n: int, t: int) -> bool:
    """Static verdict for ``mode``'s GEMM at (n, t): its CUDA route's
    carriers and gathers, every tile's block, and the dispatch contract
    (trivially True for a mode without a kernel: there is nothing to
    certify).  ``engine.config.resolve_t(..., mode=...)`` consults it."""
    from repro_torch.engine import modes as engine_modes

    if engine_modes.get_mode(mode).cuda is None:
        return True
    return _audit_gemm(mode, n, t).certified


@functools.lru_cache(maxsize=1024)
def certified_elementwise(n: int, t: int) -> bool:
    """Static verdict for the packed single-word elementwise kernel."""
    return audit_kernel(contracts.kernel_trace("packed_single", n, t)).certified


@functools.lru_cache(maxsize=1024)
def certified_kernel(kind: str, n: int, t: int) -> bool:
    """Static verdict for a kernel-level contract (``contracts.KERNEL_KINDS``)."""
    return audit_kernel(contracts.kernel_trace(kind, n, t)).certified


@functools.lru_cache(maxsize=1024)
def certified_row(mode: str, n: int, t: int, shards: int) -> bool:
    """Static verdict for ``mode``'s row-parallel route over ``shards`` K
    shards (``contracts.gemm_trace(..., shards=)``): the integer epilogue
    of each shard and the int64 sum of their partials, within the mode's
    dispatch contract and its certified whole route."""
    if not certified(mode, n, t):
        return False
    spec = contracts.gemm_trace(mode, n, t, shards=shards)
    return audit_kernel(spec, family="gemm", mode=mode, n=n, t=t).certified


def require_certified(mode: str, n: int, t: int, *, elementwise: bool = False) -> None:
    """Raise :class:`CertificationError` unless ``mode``'s GEMM (or, with
    ``elementwise``, the packed single-word kernel) is certified at (n, t)."""
    ok = certified_elementwise(n, t) if elementwise else certified(mode, n, t)
    if not ok:
        raise CertificationError(
            f"static audit has not certified mode {mode!r} at (n={n}, t={t}); run "
            f"`python -m repro_torch.launch.analyze` for the findings")


@functools.lru_cache(maxsize=256)
def _attention_traced(mode: str, n: int, t: int) -> bool:
    return audit_kernel(contracts.attention_trace(mode, n, t)).certified


@functools.lru_cache(maxsize=1024)
def certified_attention(mode: str, n: int, t: int, hd: int, rank: int) -> bool:
    """Static verdict for the approximate attention kernel of ``mode``: its
    function's gathers at (n, t) (traced once per (mode, n, t)) and its
    block at head width ``hd`` and ``rank``."""
    try:
        smem.validate_attention(mode, n, hd, rank)
    except smem.TileBudgetError:
        return False
    return _attention_traced(mode, n, t)


@functools.lru_cache(maxsize=64)
def certified_flash(hd: int, dtype) -> bool:
    """Static verdict for the exact attention kernels at head width ``hd``:
    every block within Hopper's limits."""
    return all(fp.within for fp in smem.attention_footprints(hd, dtype))


GATE_CHECKS: collections.Counter = collections.Counter()


def gate(kernel: str, what: str, n: int = 0, t: int = 0, **config: Any) -> None:
    """The dispatch-time gate, which ``kernels.build.audit_gate`` calls when
    ``REPRO_STATIC_AUDIT=1`` is set: refuse a launch of ``kernel`` that the
    audit has not certified (before it launches, with
    :class:`CertificationError`) and count each check in
    :data:`GATE_CHECKS`.  ``what`` names the
    certificate: an engine mode (its CUDA route, :func:`certified`), a
    kernel kind (``contracts.KERNEL_KINDS``, :func:`certified_kernel`),
    ``"packed_single"`` (:func:`certified_elementwise`),
    ``"attention:<mode>"`` (with ``hd`` and ``rank``), ``"flash"`` (with
    ``hd`` and ``dtype``) or ``"row:<mode>"`` (with ``shards``,
    :func:`certified_row`)."""
    if what == "flash":
        ok = certified_flash(config["hd"], config["dtype"])
    elif what.startswith("attention:"):
        ok = certified_attention(what[10:], n, t, config["hd"], config["rank"])
    elif what.startswith("row:"):
        ok = certified_row(what[4:], n, t, config["shards"])
    elif what == "packed_single":
        ok = certified_elementwise(n, t)
    elif what in contracts.KERNEL_KINDS:
        ok = certified_kernel(what, n, t)
    else:
        ok = certified(what, n, t)
    if not ok:
        detail = ", ".join(f"{k}={v}" for k, v in config.items())
        raise CertificationError(
            f"static audit has not certified {what!r} at (n={n}, t={t}{', ' if detail else ''}"
            f"{detail}) for {kernel}, and REPRO_STATIC_AUDIT=1 forbids launching unproven "
            f"kernels; run `python -m repro_torch.launch.analyze` for the findings")
    GATE_CHECKS[kernel] += 1
