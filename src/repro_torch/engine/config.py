"""Accuracy-configuration subsystem: tiers, error budgets, the (n, t) controller.

Counterpart of ``repro/engine/config.py``.  The splitting point ``t`` is
the paper's quality knob: the segmented carry chain shortens the adder
critical path to ``max(t, n - t)`` full-adder delays at the price of a
deferred-carry error that grows with ``t``.

* :func:`resolve_t` returns the cheapest split (minimal cycle delay,
  ties toward the smaller ``t``) whose closed-form error estimates
  (``core.error_model``) meet an :class:`ErrorBudget`.
* :class:`QualityTier` / :func:`resolve_tier` name the tiers ``exact``,
  ``high``, ``balanced`` and ``draft``, with per-GEMM-class budgets;
  :func:`apply_quality` deploys one onto a ``ModelConfig``.
* :func:`tier_cycle_factor` is the gate-delay model's per-step cost of a
  tier relative to the exact design.
* :func:`kernel_tiles` checks the Hopper kernels' tiles for one call.

Certification stand-in.  With ``mode`` set, the reference's
``resolve_t`` keeps only splits that its jaxpr auditor
(``repro.analysis``) has proven overflow-, gather- and VMEM-safe.  That
auditor is not ported (ROADMAP.md, "Modules to port" item 12), so the
port filters candidates through the static integer envelopes instead:
the per-mode bit-width ceilings of ``engine.dispatch._MODE_MAX_N`` and,
for the packed single-word elementwise products, ``2n <= 31``.  The
integer accumulators of the CUDA kernels are sized per call
(``kernels.build.wide_accumulator``), so they add no envelope of their
own.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

from repro_torch.configs.base import ApproxConfig, LayerQuality, ModelConfig
from repro_torch.core import error_model
from repro_torch.kernels.build import SMEM_PER_BLOCK

__all__ = [
    "T_FA",
    "T_MUX",
    "ripple_delay",
    "segmented_delay",
    "cycle_delay",
    "ErrorBudget",
    "TPoint",
    "QualityError",
    "sweep_t",
    "resolve_t",
    "within_envelope",
    "DEFAULT_N",
    "default_t",
    "kernel_tiles",
    "QualityTier",
    "QualityConfig",
    "register_tier",
    "get_tier",
    "list_tiers",
    "resolve_tier",
    "apply_quality",
    "tier_cycle_factor",
]


# ------------------------------------------------------------- cycle cost
T_FA = 1.0  # full-adder delay
T_MUX = 0.4  # fix-to-1 mux + D-FF setup margin


def ripple_delay(n: int) -> float:
    """Accurate multiplier: the carry ripples across all n positions."""
    return n * T_FA


def segmented_delay(n: int, t: int) -> float:
    """Approximate multiplier: the D-FF cuts the chain at ``t``; the
    critical path is the longer segment plus the fix-to-1 mux."""
    return max(t, n - t) * T_FA + T_MUX


def cycle_delay(n: int, t: int) -> float:
    """The controller's cost: per-cycle critical path of the (n, t) design."""
    return segmented_delay(n, t)


# ---------------------------------------------------------- error budgets
@dataclasses.dataclass(frozen=True)
class ErrorBudget:
    """Upper bounds a resolved split must satisfy (``None`` = unbounded):
    ``max_er`` on the Eq. 10 ER estimate, ``max_nmed`` on the MED estimate
    normalized by ``(2^n - 1)^2``, ``max_mae`` on Eq. 11."""

    max_er: Optional[float] = None
    max_nmed: Optional[float] = None
    max_mae: Optional[int] = None

    def admits(self, point: "TPoint") -> bool:
        if self.max_er is not None and point.er_bound > self.max_er:
            return False
        if self.max_nmed is not None and point.nmed_est > self.max_nmed:
            return False
        if self.max_mae is not None and point.mae > self.max_mae:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class TPoint:
    """One candidate split with its closed-form metrics and cycle cost."""

    n: int
    t: int
    order: int
    er_bound: float
    med_abs_est: float
    nmed_est: float
    mae: int
    delay: float


class QualityError(ValueError):
    """No splitting point satisfies the requested error budget."""


def _sweep(n: int, order: int, pa, pb) -> tuple:
    points = []
    max_p = max((2**n - 1) ** 2, 1)
    for t in range(1, max(1, n - 1) + 1):
        est = error_model.estimate(n, t, order=order, pa=pa, pb=pb)
        points.append(TPoint(
            n=n,
            t=t,
            order=order,
            er_bound=est.er_msp,
            med_abs_est=est.med_abs_est,
            nmed_est=est.med_abs_est / max_p,
            mae=error_model.mae_closed_form(n, t),
            delay=cycle_delay(n, t),
        ))
    return tuple(points)


@functools.lru_cache(maxsize=256)
def sweep_t(n: int, *, order: int = 1) -> tuple:
    """Closed-form metrics for every valid split of bit-width ``n``
    (uniform input marginals)."""
    return _sweep(n, order, None, None)


def within_envelope(mode: str, n: int, t: int) -> bool:
    """The static integer envelope a (mode, n, t) must lie in: the port's
    stand-in for the reference's kernel certification (module docstring)."""
    from repro_torch.engine.dispatch import _MODE_MAX_N, PACKED_U32_MAX_2N

    if n > _MODE_MAX_N.get(mode, n):
        return False
    if mode in ("seqmul_approx", "seqmul_exact") and 2 * n > PACKED_U32_MAX_2N:
        return False
    return True


def resolve_t(
    n: int,
    budget: ErrorBudget,
    *,
    order: int = 1,
    pa=None,
    pb=None,
    mode: Optional[str] = None,
) -> TPoint:
    """The controller: cheapest split meeting ``budget``.

    Keeps the candidates whose closed-form bounds satisfy the budget and
    returns the one minimizing ``(cycle_delay, t)``.  Raises
    :class:`QualityError` when none does.  With ``mode`` set, candidates
    outside the mode's static integer envelope (:func:`within_envelope`)
    are dropped too.
    """
    if pa is None and pb is None:
        points = sweep_t(n, order=order)
    else:
        points = _sweep(n, order, pa, pb)
    valid = [p for p in points if budget.admits(p)]
    if not valid:
        raise QualityError(
            f"no splitting point t in [1, {max(1, n - 1)}] for n={n} meets "
            f"{budget} (tightest candidate: t=1 with er<={points[0].er_bound:.3f}, "
            f"nmed<={points[0].nmed_est:.2e}, mae={points[0].mae})"
        )
    if mode is not None:
        inside = [p for p in valid if within_envelope(mode, n, p.t)]
        if not inside:
            raise QualityError(
                f"every budget-valid splitting point for mode {mode!r} at n={n} "
                f"(t in {[p.t for p in valid]}) lies outside the mode's integer envelope"
            )
        valid = inside
    return min(valid, key=lambda p: (p.delay, p.t))


DEFAULT_N = 8  # LUT-backed modes require n <= 8; the engine-wide default


# ------------------------------------------------- CUDA kernel parameters
def _lut_smem_bytes(n: int, bm: int) -> int:
    """``csrc/lut_matmul.cu``'s dynamic shared memory at row tile ``bm``
    (``kernels.lut_matmul.smem_bytes``): the uint16 table and one stage of
    operand words."""
    from repro_torch.kernels.lut_matmul import smem_bytes

    return smem_bytes(n, bm)


def _lowrank_smem_bytes(n: int, bm: int, rank: int) -> int:
    """``csrc/lowrank_matmul.cu``'s dynamic shared memory at token tile
    ``bm`` (``kernels.lowrank_matmul.smem_bytes``)."""
    from repro_torch.kernels.lowrank_matmul import smem_bytes

    return smem_bytes(n, bm, rank)


_SMEM_BYTES = {
    "bitexact": lambda n, bm, rank: _lut_smem_bytes(n, bm),
    "lowrank": _lowrank_smem_bytes,
}


@functools.lru_cache(maxsize=1024)
def kernel_tiles(mode: str, n: int, t: int, m: int, rank: int = 8) -> int:
    """The CUDA kernels' row tile for one GEMM call of ``m`` rows, checked.

    The row tile is picked from M by each kernel's wrapper, through the
    ``tile`` of ``kernels.lut_matmul`` (``bitexact``),
    ``kernels.seqmul_matmul`` (``seqmul``), ``kernels.lowrank_matmul``
    (``lowrank``) and ``kernels.packed_matmul`` (``inject``); this returns
    that pick.  For the modes that hold tables in shared memory
    (``bitexact``: the uint16 product table; ``lowrank``: the two SVD
    factors, which grow with ``rank``) the footprint is checked against
    the 227 KiB a block may use, at dispatch rather than at launch.  ``t``
    shapes the table contents or the recurrence, not the footprint.
    """
    from repro_torch.kernels import lowrank_matmul, lut_matmul, packed_matmul, seqmul_matmul

    bm = {"bitexact": lut_matmul, "seqmul": seqmul_matmul, "lowrank": lowrank_matmul,
          "inject": packed_matmul}[mode].tile(m)[0]
    footprint = _SMEM_BYTES.get(mode)
    if footprint is not None and footprint(n, bm, rank) > SMEM_PER_BLOCK:
        raise ValueError(
            f"{mode} at n={n}, t={t}, rank={rank}: {footprint(n, bm, rank)} bytes of "
            f"shared memory per block, over the {SMEM_PER_BLOCK} a Hopper block may use"
        )
    return bm


@functools.lru_cache(maxsize=64)
def default_t(n: int = DEFAULT_N) -> int:
    """Engine-wide default split for bit-width ``n``: the ``balanced``
    tier's mlp budget resolved by the controller (``default_t(8) == 4``)."""
    tier = get_tier("balanced")
    return resolve_t(n, dict(tier.budgets)["mlp"]).t


# ----------------------------------------------------------------- tiers
@dataclasses.dataclass(frozen=True)
class QualityTier:
    """A named quality level: an engine mode plus per-GEMM-class budgets;
    a target without a budget stays exact."""

    name: str
    mode: str
    budgets: tuple = ()  # ((target, ErrorBudget), ...)
    backend: str = "auto"
    description: str = ""

    @property
    def targets(self) -> tuple:
        return tuple(t for t, _ in self.budgets)


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """A tier resolved against a bit-width: one LayerQuality per target."""

    tier: str
    n: int
    order: int
    mode: str
    backend: str
    per_target: tuple  # of LayerQuality

    @property
    def targets(self) -> tuple:
        return tuple(q.target for q in self.per_target)

    def describe(self) -> str:
        if not self.per_target:
            return f"tier {self.tier}: exact (approximation disabled)"
        cells = ", ".join(
            f"{q.target}(n={q.n}, t={q.t}, {q.mode or self.mode})"
            for q in self.per_target
        )
        return f"tier {self.tier}: {cells} [{self.backend}]"


_TIERS: dict[str, QualityTier] = {}


def register_tier(tier: QualityTier) -> QualityTier:
    if tier.name in _TIERS:
        raise ValueError(f"tier {tier.name!r} is already registered")
    _TIERS[tier.name] = tier
    return tier


def get_tier(name: Union[str, QualityTier]) -> QualityTier:
    if isinstance(name, QualityTier):
        return name
    try:
        return _TIERS[name]
    except KeyError:
        raise ValueError(
            f"unknown quality tier {name!r}; registered tiers: {list_tiers()}"
        ) from None


def list_tiers() -> list[str]:
    return sorted(_TIERS)


# Budgets on the NMED scale, as in the reference.  At n=8 they resolve to:
# high -> mlp/moe t=2, attn t=1; balanced -> mlp/moe t=4, attn t=2;
# draft -> t=4 with the inject surrogate (pinned by the tests).
register_tier(QualityTier(
    name="exact",
    mode="exact",
    description="no approximation (baseline quality)",
))
register_tier(QualityTier(
    name="high",
    mode="bitexact",
    budgets=(
        ("mlp", ErrorBudget(max_nmed=2e-3)),
        ("moe", ErrorBudget(max_nmed=2e-3)),
        ("attn", ErrorBudget(max_nmed=1e-3)),
    ),
    description="tight NMED budget; short splits, attention tightest",
))
register_tier(QualityTier(
    name="balanced",
    mode="bitexact",
    budgets=(
        ("mlp", ErrorBudget(max_nmed=1e-2)),
        ("moe", ErrorBudget(max_nmed=1e-2)),
        ("attn", ErrorBudget(max_nmed=2e-3)),
    ),
    description="the paper's working point: delay-optimal mlp split at n=8",
))
register_tier(QualityTier(
    name="draft",
    mode="inject",
    budgets=(
        ("mlp", ErrorBudget(max_nmed=5e-2)),
        ("moe", ErrorBudget(max_nmed=5e-2)),
    ),
    description="loose budget, moment-matched injection (throughput first)",
))


def resolve_tier(
    tier: Union[str, QualityTier],
    *,
    n: int = DEFAULT_N,
    order: int = 1,
) -> QualityConfig:
    """Resolve a tier's budgets into per-target (n, t) selections, each
    through :func:`resolve_t` with the tier's mode."""
    spec = get_tier(tier)
    per_target = tuple(
        LayerQuality(
            target=target,
            n=n,
            t=resolve_t(n, budget, order=order, mode=spec.mode).t,
            mode=spec.mode,
            backend=spec.backend,
        )
        for target, budget in spec.budgets
    )
    return QualityConfig(
        tier=spec.name, n=n, order=order, mode=spec.mode,
        backend=spec.backend, per_target=per_target,
    )


@functools.lru_cache(maxsize=64)
def tier_cycle_factor(
    tier: Optional[str],
    *,
    n: int = DEFAULT_N,
    order: int = 1,
) -> float:
    """Relative per-cycle cost of serving at ``tier`` vs the exact design:
    the mean segmented critical path over the tier's resolved splits over
    the ripple delay (``exact``/``None``: 1.0)."""
    if tier is None:
        return 1.0
    qc = resolve_tier(tier, n=n, order=order)
    if not qc.per_target:
        return 1.0
    mean_delay = sum(segmented_delay(q.n, q.t) for q in qc.per_target)
    mean_delay /= len(qc.per_target)
    return mean_delay / ripple_delay(n)


def apply_quality(
    cfg: ModelConfig,
    tier: Union[str, QualityTier],
    *,
    n: int = DEFAULT_N,
    order: int = 1,
) -> ModelConfig:
    """Deploy a quality tier onto a model config (``exact`` disables
    approximation; otherwise each budgeted target gets its resolved
    ``LayerQuality`` override)."""
    qc = resolve_tier(tier, n=n, order=order)
    if not qc.per_target:
        return dataclasses.replace(cfg, approx=ApproxConfig(enabled=False))
    from repro_torch.engine import modes as engine_modes

    engine_modes.get_mode(qc.mode)
    base = qc.per_target[0]
    return dataclasses.replace(cfg, approx=ApproxConfig(
        enabled=True,
        n=base.n,
        t=base.t,
        fix_to_1=cfg.approx.fix_to_1,
        mode=qc.mode,
        rank=cfg.approx.rank,
        targets=qc.targets,
        backend=qc.backend,
        overrides=qc.per_target,
    ))
