"""Closed-form and probabilistic error models (paper Sections IV-B, V-A/B).

The exact metrics are #P-complete (paper Theorems 1–2), so the paper
proposes propagating the signal probabilities ρ(Ŝ_i^j), ρ(Ĉ_i^j) through
the DNF forms of Eqs. (12)/(13), keeping cofactors w.r.t. the a-bits and
deliberately disregarding Ŝ–Ĉ cross-correlations.  We implement two
fidelity levels:

* ``order=0`` — full independence: propagate per-bit marginals, but
  condition each cycle exactly on b_j (the shared AND input, whose
  correlation across bit positions is structural, not incidental).
* ``order=1`` — the paper's cofactor scheme: every carry is tracked
  jointly with the a-bit of the position it was produced at, and every
  accumulated-sum bit with the a-bit one position below (which, after the
  right shift, is precisely the ``ρ(·|{a_i} ∪ V)`` cofactor the paper's
  product expansion consumes).

Both return per-cycle carry-crossing probabilities (Eq. 9), an ER upper
estimate combining cycles under independence (truncated Eq. 10), the
MAE-event probability ρ(Ĉ_{t-1}^{n-2} ∧ ¬Ĉ_{t-1}^{n-1}), and a MED
estimate from the deferred-carry weight ledger.  Calibration against
exhaustive ground truth is in ``benchmarks/error_tables.py``.

Empirical note recorded in EXPERIMENTS.md: the closed-form Eq. (11)
matches, bit-exactly, the maximum-magnitude *negative* ED of the design
with fix-to-1 disabled (deferred carries land one position high after the
shift, each overshooting by its own weight; the worst-case accumulation
telescopes to 2^{n+t-1} - 2^{t+1}).  The positive side (final-cycle carry
dropped, no fix) reaches 2^{n+t-1} exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.engine.recurrence import validate_nt

__all__ = [
    "mae_closed_form",
    "max_ed_dropped_carry",
    "EstimatorReport",
    "estimate",
]


def mae_closed_form(n: int, t: int) -> int:
    """Eq. (11): MAE = 2^{n+t-1} - 2^{t+1}.

    Degenerate splits accepted by ``validate_nt`` sit outside the paper's
    1 <= t <= n-1, n >= 2 derivation and are defined explicitly: at n=1
    the single-cycle product never produces an LSP carry, so exact and
    approximate coincide and the maximum deferred-carry overshoot is 0
    (the raw formula would go negative).  n=2, t=1 evaluates to 0 through
    the formula itself — the one-cycle deferral window closes before the
    deferred carry could land high — and is cross-checked against
    exhaustive enumeration via ``core.boolean_ref`` in the tests.
    """
    validate_nt(n, t)
    if n == 1:
        return 0
    return (1 << (n + t - 1)) - (1 << (t + 1))


def max_ed_dropped_carry(n: int, t: int) -> int:
    """Worst positive ED (p̂ < p) when the final LSP carry is dropped
    and fix-to-1 is disabled: the carry's product weight 2^{t} * 2^{n-1}."""
    validate_nt(n, t)
    if n == 1:
        return 0
    return 1 << (n + t - 1)


@dataclasses.dataclass(frozen=True)
class EstimatorReport:
    n: int
    t: int
    order: int
    er_per_cycle: tuple  # Eq. (9) per accumulation j = 1..n-1
    er_msp: float  # P(any MSP-observable error), independence-combined
    p_ed_mae: float  # ρ(Ĉ_{t-1}^{n-2} ∧ ¬Ĉ_{t-1}^{n-1})
    p_fix: float  # ρ(Ĉ_{t-1}^{n-1}): fix-to-1 firing probability
    med_abs_est: float  # deferred-carry weight ledger estimate of mean |ED|


def _half_adder_chain(paug, pm, c_in0, t_boundary=None, c_boundary=0.0):
    """Ripple a probabilistic carry chain over positions 0..len-1.

    paug[i], pm[i]: P(augend/addend bit = 1), independent.
    Returns (psum[i], carry_into[i+1] list); at ``t_boundary`` the chain's
    incoming carry is replaced by ``c_boundary`` (the deferred D-FF value)
    while the native carry-out at t_boundary-1 is reported separately.
    A boundary at ``nbits`` means the whole chain is LSP (degenerate n=1
    split): the reported LSP carry-out is the final carry.  Boundaries
    beyond the chain used to silently report a 0.0 LSP carry-out; they
    are rejected now.
    """
    nbits = len(paug)
    if t_boundary is not None and t_boundary > nbits:
        raise ValueError(f"t_boundary={t_boundary} beyond the {nbits}-bit chain")
    psum = np.zeros(nbits)
    c = c_in0
    c_lsp_out = 0.0
    for i in range(nbits):
        if t_boundary is not None and i == t_boundary:
            c_lsp_out = c
            c = c_boundary
        g = paug[i] * pm[i]
        pp = paug[i] * (1 - pm[i]) + (1 - paug[i]) * pm[i]
        psum[i] = pp * (1 - c) + (1 - pp) * c
        c = g + pp * c
    if t_boundary == nbits:
        c_lsp_out = c
    return psum, c, c_lsp_out


def _estimate_order0(n, t, pa, pb):
    """Independence propagation, conditioned exactly on each b_j."""
    ps = np.zeros(n + 1)  # P(S_i = 1), i in [0, n]
    p_cff = 0.0
    er_cycles = []
    p_cff_hist = [0.0]
    for j in range(n):
        paug = ps[1:].copy()  # S >> 1; aug bit n-1 gets S_n
        paug = np.concatenate([paug, [0.0]])[:n]
        new_ps = np.zeros(n + 1)
        er_j = 0.0
        cff_j = 0.0
        for bj, w in ((1, pb[j]), (0, 1 - pb[j])):
            pm = pa * bj
            psum, c_msp_out, c_lsp_out = _half_adder_chain(
                paug, pm, 0.0, t_boundary=t, c_boundary=p_cff
            )
            new_ps[:n] += w * psum
            new_ps[n] += w * c_msp_out
            er_j += w * c_lsp_out
            cff_j += w * c_lsp_out
        ps = new_ps
        p_cff = cff_j
        if j > 0:
            er_cycles.append(er_j)
        p_cff_hist.append(p_cff)
    return er_cycles, p_cff_hist


def _estimate_order1(n, t, pa, pb):
    """Cofactor propagation w.r.t. a-bits (paper Section V-B scheme).

    State: ps_c[i, v] = P(S_i = 1 | a_{i-1} = v).  After the right shift,
    position i's augend is old S_{i+1}, whose tracked conditioning variable
    is a_i — exactly the cofactor ρ(Ŝ_{i+1}^{j-1} | {a_i}) used by the
    paper's product expansion.  Carries are rippled with their joint
    dependence on the a-bit one position below.
    """
    ps_c = np.zeros((n + 1, 2))  # P(S_i=1 | a_{i-1}=v); i=0 column unused
    p_cff = 0.0
    er_cycles = []
    p_cff_hist = [0.0]
    for j in range(n):
        new_ps = np.zeros((n + 1, 2))
        er_j = 0.0
        cff_j = 0.0
        for bj, w in ((1, pb[j]), (0, 1 - pb[j])):
            # carry into position i, conditioned on a_{i-1}: c_cond[v]
            c_cond = np.zeros(2)
            sum_cond_prev = np.zeros((n + 1, 2))  # P(sum_i | a_{i-1})
            c_out_lsp = 0.0
            for i in range(n):
                paug_c = ps_c[i + 1]  # P(aug_i=1 | a_i = v)
                if i == t:
                    # marginalize over a_{i-1}.  estimate() already
                    # enforces t >= 1 via validate_nt; the i > 0 guard is
                    # defensive for direct callers so a boundary at 0 can
                    # never read pa[-1] (the old silent wraparound).
                    c_out_lsp = (
                        pa[i - 1] * c_cond[1] + (1 - pa[i - 1]) * c_cond[0]
                        if i > 0
                        else c_cond[0]
                    )
                    c_cond = np.array([p_cff, p_cff])  # D-FF, decorrelated
                c_marg = (
                    pa[i - 1] * c_cond[1] + (1 - pa[i - 1]) * c_cond[0]
                    if i > 0
                    else c_cond[0]
                )
                # sum bit conditioned on a_{i-1} (carry keeps the correlation)
                pp_m = 0.0
                c_next = np.zeros(2)
                for va in (0, 1):
                    wa = pa[i] if va else 1 - pa[i]
                    pm = va * bj
                    g = paug_c[va] * pm
                    pp = paug_c[va] * (1 - pm) + (1 - paug_c[va]) * pm
                    pp_m += wa * pp
                    c_next[va] = g + pp * c_marg
                for v in (0, 1):
                    cv = c_cond[v] if i > 0 else c_cond[0]
                    sum_cond_prev[i, v] = pp_m * (1 - cv) + (1 - pp_m) * cv
                c_cond = c_next
            if t == n:  # degenerate n=1 split: the whole chain is LSP
                c_out_lsp = pa[n - 1] * c_cond[1] + (1 - pa[n - 1]) * c_cond[0]
            c_msp_out = pa[n - 1] * c_cond[1] + (1 - pa[n - 1]) * c_cond[0]
            sum_cond_prev[n, :] = c_msp_out
            new_ps += w * sum_cond_prev
            er_j += w * c_out_lsp
            cff_j += w * c_out_lsp
        ps_c = new_ps
        p_cff = cff_j
        if j > 0:
            er_cycles.append(er_j)
        p_cff_hist.append(p_cff)
    return er_cycles, p_cff_hist


def estimate(
    n: int,
    t: int,
    *,
    order: int = 1,
    pa: np.ndarray | None = None,
    pb: np.ndarray | None = None,
) -> EstimatorReport:
    """Probabilistic metric estimation.

    pa/pb: per-bit P(bit = 1) of the operands (length n); default 0.5
    (uniform inputs).  A measured input PDF maps to per-bit marginals —
    the estimator only consumes marginals, mirroring the paper.

    ``(n, t)`` is validated through the engine's ``validate_nt`` (the
    same gate the recurrence itself applies), and ``pa``/``pb`` must be
    length-n probability vectors — the estimator used to silently accept
    invalid shapes and wrap negative indices.
    """
    validate_nt(n, t)
    pa = np.full(n, 0.5) if pa is None else np.asarray(pa, float)
    pb = np.full(n, 0.5) if pb is None else np.asarray(pb, float)
    for name, p in (("pa", pa), ("pb", pb)):
        if p.shape != (n,):
            raise ValueError(f"{name} must have shape ({n},), got {p.shape}")
        if np.any(p < 0.0) or np.any(p > 1.0):
            raise ValueError(f"{name} entries must be probabilities in [0, 1]")
    if order == 0:
        er_cycles, cff = _estimate_order0(n, t, pa, pb)
    elif order == 1:
        er_cycles, cff = _estimate_order1(n, t, pa, pb)
    else:
        raise ValueError(f"order must be 0 or 1, got {order}")

    er_msp = 1.0 - float(np.prod([1 - e for e in er_cycles]))
    # cff[j+1] is ρ(Ĉ_{t-1}^{j}); MAE event: carry at cycle n-2, none at n-1.
    p_ed_mae = float(cff[n - 1] * (1 - cff[n]))
    p_fix = float(cff[n])
    # deferred-carry ledger: a carry crossing at cycle j is re-applied one
    # position high -> |ED| contribution 2^{t+j-1}; the final cycle's is
    # dropped (fix-to-1 aside) -> 2^{t+n-2} expected... we sum expectations.
    med = sum(er_cycles[j - 1] * float(2 ** (t + j - 1)) for j in range(1, n - 1))
    med += cff[n] * float(2 ** (t + n - 2))
    return EstimatorReport(
        n=n,
        t=t,
        order=order,
        er_per_cycle=tuple(er_cycles),
        er_msp=er_msp,
        p_ed_mae=p_ed_mae,
        p_fix=p_fix,
        med_abs_est=med,
    )
