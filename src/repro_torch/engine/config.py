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
  tier relative to the exact design; :func:`accept_rate_estimate`,
  :func:`expected_round_tokens`, :func:`speculation_gain` and
  :func:`best_spec_k` are the economics of self-speculative decoding.
* :func:`kernel_tiles` checks the Hopper kernels' tiles for one call
  against the shared-memory model of ``analysis.smem``.

With ``mode`` set, :func:`resolve_t` keeps only the splits that the
static certifier (``repro_torch.analysis``) has proven overflow-, gather-
and shared-memory-safe for that mode's CUDA kernel, as the reference's
does with its jaxpr auditor.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

from repro_torch.configs.base import ApproxConfig, LayerQuality, ModelConfig
from repro_torch.core import error_model

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
    "accept_rate_estimate",
    "expected_round_tokens",
    "speculation_gain",
    "best_spec_k",
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
    are filtered through the static kernel audit
    (:func:`repro_torch.analysis.audit.certified`): the controller can only
    return an (n, t) whose CUDA route the certifier has proven safe, and
    raises :class:`QualityError` naming certification when none is.
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
        from repro_torch.analysis import audit  # lazy: the audit imports the engine

        certified = [p for p in valid if audit.certified(mode, n, p.t)]
        if not certified:
            raise QualityError(
                f"every budget-valid splitting point for mode {mode!r} at n={n} "
                f"(t in {[p.t for p in valid]}) failed static kernel certification; run "
                f"`python -m repro_torch.launch.analyze` for the findings"
            )
        valid = certified
    return min(valid, key=lambda p: (p.delay, p.t))


DEFAULT_N = 8  # LUT-backed modes require n <= 8; the engine-wide default


# ------------------------------------------------- CUDA kernel parameters
@functools.lru_cache(maxsize=1024)
def kernel_tiles(mode: str, n: int, t: int, m: int, rank: int = 8) -> int:
    """The CUDA kernels' row tile for one GEMM call of ``m`` rows, checked.

    The tile is picked from M by each kernel's wrapper, through the
    ``tile`` of ``kernels.lut_matmul`` (``bitexact``),
    ``kernels.seqmul_matmul`` (``seqmul``), ``kernels.lowrank_matmul``
    (``lowrank``) and ``kernels.packed_matmul`` (``inject``); this returns
    its rows after ``analysis.smem.validate_tiles`` has checked the block
    against Hopper's shared memory and threads (the uint16 table of
    ``bitexact`` and the SVD factors of ``lowrank``, which grow with
    ``rank``, at dispatch rather than at launch).  Raises
    ``TileBudgetError`` (a ``ValueError``) naming (mode, n, t).
    """
    from repro_torch.analysis import smem

    tile = smem._gemm_module(mode).tile(m)
    smem.validate_tiles(mode, n, t, tile, rank=rank)
    return tile[0]


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



# ------------------------------------------------- self-speculative decoding
@functools.lru_cache(maxsize=256)
def accept_rate_estimate(
    draft_tier: Union[str, QualityTier],
    verify_tier: Union[str, QualityTier],
    *,
    n: int = DEFAULT_N,
    order: int = 1,
) -> float:
    """Closed-form lower bound on the draft-vs-verify agreement rate.

    Self-speculative decoding (``serve.strategy.SelfSpeculative``) runs the
    same weights at two tiers; a proposal is accepted when both tiers'
    greedy argmax agree.  Per budgeted GEMM class the chance that either
    tier's multiply deviates from exact is union-bounded by the sum of the
    two resolved splits' Eq. 10 ER estimates; the product over classes of
    ``max(0, 1 - (er_d + er_v))`` bounds the chance that both forwards
    match the exact one, and so each other.  Two tiers with identical
    resolved configurations give 1.0.
    """
    qd = resolve_tier(get_tier(draft_tier), n=n, order=order)
    qv = resolve_tier(get_tier(verify_tier), n=n, order=order)
    if (qd.mode, qd.per_target) == (qv.mode, qv.per_target):
        return 1.0

    def er(qc: QualityConfig, target: str) -> float:
        for q in qc.per_target:
            if q.target == target:
                return sweep_t(q.n, order=order)[q.t - 1].er_bound
        return 0.0  # unbudgeted target: exact at this tier

    targets = {q.target for q in qd.per_target} | {q.target for q in qv.per_target}
    est = 1.0
    for tgt in sorted(targets):
        est *= max(0.0, 1.0 - (er(qd, tgt) + er(qv, tgt)))
    return est


def expected_round_tokens(accept_rate: float, k: int) -> float:
    """Expected committed tokens of one speculative round at depth ``k``:
    a Bernoulli(α) acceptance chain stopped at the first rejection plus the
    verify step's bonus token, ``(1 - α^(k+1)) / (1 - α)`` (``k + 1`` at
    α = 1)."""
    if not 0.0 <= accept_rate <= 1.0:
        raise ValueError(f"accept_rate must be in [0, 1], got {accept_rate}")
    if k < 1:
        raise ValueError(f"speculation depth k must be >= 1, got {k}")
    if accept_rate >= 1.0:
        return float(k + 1)
    return (1.0 - accept_rate ** (k + 1)) / (1.0 - accept_rate)


def speculation_gain(
    draft_tier: Union[str, QualityTier],
    verify_tier: Union[str, QualityTier],
    k: int,
    *,
    n: int = DEFAULT_N,
    order: int = 1,
) -> float:
    """Modeled tokens-per-cost ratio of speculating vs plain verify decode:
    ``E * f_verify / (k * f_draft + f_verify)`` with ``E`` the expected
    round tokens and ``f`` the tiers' :func:`tier_cycle_factor`; above 1.0
    speculation pays, and ``draft == verify`` gives exactly 1.0."""
    alpha = accept_rate_estimate(draft_tier, verify_tier, n=n, order=order)
    e_tokens = expected_round_tokens(alpha, k)
    f_d = tier_cycle_factor(get_tier(draft_tier).name, n=n, order=order)
    f_v = tier_cycle_factor(get_tier(verify_tier).name, n=n, order=order)
    return e_tokens * f_v / (k * f_d + f_v)


def best_spec_k(
    draft_tier: Union[str, QualityTier],
    verify_tier: Union[str, QualityTier],
    *,
    k_max: int = 8,
    n: int = DEFAULT_N,
    order: int = 1,
) -> tuple[int, float]:
    """``(k, gain)`` maximizing :func:`speculation_gain` over ``1 <= k <=
    k_max``, ties toward the smaller depth; ``gain <= 1`` means "don't
    speculate"."""
    if k_max < 1:
        raise ValueError(f"k_max must be >= 1, got {k_max}")
    best = (1, speculation_gain(draft_tier, verify_tier, 1, n=n, order=order))
    for k in range(2, k_max + 1):
        g = speculation_gain(draft_tier, verify_tier, k, n=n, order=order)
        if g > best[1]:
            best = (k, g)
    return best


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
