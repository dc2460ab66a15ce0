"""Empirical error metrics of Section III-B (BER, ER, ED, MAE, MED, NMED, MRED).

Counterpart of ``repro/core/error_metrics.py``.  Metrics are computed on
the host in exact integer arithmetic (numpy int64 / uint64) from products
simulated on the entry point's device (``device=None`` means ``cuda``, see
``repro_torch.device``) — float rounding would corrupt EDs at n = 32.  The
products come from ``kernels.seqmul_kernel.seqmul_words`` for n <= 16 (the
kernel on the card, its plain version on the CPU) and from
``core.seqmul.seq_mul_words`` above that.  The host accumulation
(``_Accum``) is the reference's, copied as it is, so the reports equal the
reference's field for field.  Both exhaustive (paper:
n <= 16) and Monte-Carlo (paper: 2^32 patterns for n = 32) drivers are
provided, chunked so memory stays flat.

Two MED conventions are reported: the paper's Eq. (6) averages *signed*
EDs; NMED/MRED comparisons against [3] conventionally use |ED|.  We carry
both (``med_signed``, ``med_abs``) and derive NMED/MRED from ``med_abs``.
Note: Eq. (8) as printed normalizes every sample by the *global* max
product (which would make MRED == NMED); we implement the standard
per-sample ``|ED| / max(1, p(a,b))`` (cf. [3]) and record the deviation.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import seqmul
from repro_torch.device import resolve_device
from repro_torch.kernels.seqmul_kernel import WORDS_MAX_N, seqmul_words

__all__ = ["ErrorReport", "exhaustive_eval", "mc_eval", "eval_pairs"]


@dataclasses.dataclass(frozen=True)
class ErrorReport:
    n: int
    t: int
    fix_to_1: bool
    samples: int
    exhaustive: bool
    er: float  # P(p != p̂)                        Eq. (3)
    mae: int  # max |ED|                           Eq. (5)
    max_ed_pos: int  # largest p - p̂ > 0 (undershoot of p̂)
    max_ed_neg: int  # most negative p - p̂ (overshoot of p̂)
    med_signed: float  # mean ED                   Eq. (6)
    med_abs: float  # mean |ED|
    nmed: float  # med_abs / max_ab p              Eq. (7)
    mred: float  # mean |ED| / max(1, p)           Eq. (8), per-sample denom
    ber: tuple  # per-output-bit error rate        Eq. (2), len 2n

    def summary(self) -> str:
        return (
            f"n={self.n} t={self.t} fix={int(self.fix_to_1)} "
            f"ER={self.er:.4f} MAE={self.mae} MED={self.med_abs:.2f} "
            f"NMED={self.nmed:.3e} MRED={self.mred:.3e}"
        )


class _Accum:
    def __init__(self, n: int):
        self.n = n
        self.count = 0
        self.err = 0
        self.sum_ed = 0
        self.sum_abs_ed = 0
        self.max_ed = 0
        self.min_ed = 0
        self.sum_red = 0.0
        self.bit_err = np.zeros(2 * n, np.int64)

    def add(self, a: np.ndarray, b: np.ndarray, phat: np.ndarray) -> None:
        # exact products at n = 32 reach (2^32-1)^2 > int64 max: keep the
        # products unsigned and derive the signed ED from the wraparound
        # difference (|ED| < 2^63, so the reinterpretation is exact).
        pu = a.astype(np.uint64) * b.astype(np.uint64)
        phu = phat.astype(np.uint64)
        ed = (pu - phu).astype(np.int64)
        self.count += ed.size
        self.err += int(np.count_nonzero(ed))
        self.sum_ed += int(ed.sum(dtype=object)) if ed.size else 0
        self.sum_abs_ed += int(np.abs(ed).sum(dtype=object)) if ed.size else 0
        self.max_ed = max(self.max_ed, int(ed.max(initial=0)))
        self.min_ed = min(self.min_ed, int(ed.min(initial=0)))
        denom = np.maximum(pu.astype(np.float64), 1.0)
        self.sum_red += float((np.abs(ed) / denom).sum())
        diff = np.bitwise_xor(pu, phu)
        for i in range(2 * self.n):
            self.bit_err[i] += int(np.count_nonzero((diff >> np.uint64(i)) & np.uint64(1)))

    def report(self, *, t: int, fix_to_1: bool, exhaustive: bool) -> ErrorReport:
        c = max(self.count, 1)
        max_p = (2**self.n - 1) ** 2
        return ErrorReport(
            n=self.n,
            t=t,
            fix_to_1=fix_to_1,
            samples=self.count,
            exhaustive=exhaustive,
            er=self.err / c,
            mae=max(abs(self.max_ed), abs(self.min_ed)),
            max_ed_pos=self.max_ed,
            max_ed_neg=self.min_ed,
            med_signed=self.sum_ed / c,
            med_abs=self.sum_abs_ed / c,
            nmed=(self.sum_abs_ed / c) / max_p,
            mred=self.sum_red / c,
            ber=tuple(self.bit_err / c),
        )


def _u64(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().astype(np.uint64)


def _simulate(a: np.ndarray, b: np.ndarray, *, n: int, t: int, fix_to_1: bool,
              device: torch.device) -> np.ndarray:
    """The approximate products of one chunk: the operands go to ``device``
    as uint32, the recurrence runs there (the two-word kernel up to n = 16),
    the words come back to be assembled in numpy uint64."""
    a, b = (torch.from_numpy(np.asarray(x, np.uint32)).to(device) for x in (a, b))
    if n <= WORDS_MAX_N:
        low, high = seqmul_words(a, b, n=n, t=t, approx=True, fix_to_1=fix_to_1)
        return _u64(low) + (_u64(high) << np.uint64(n))
    w = seqmul.seq_mul_words(a, b, n=n, t=t, approx=True, fix_to_1=fix_to_1)
    return seqmul.assemble_product_u64(w, n=n, t=t)


def eval_pairs(
    a: np.ndarray, b: np.ndarray, *, n: int, t: int, fix_to_1: bool = True,
    exhaustive: bool = False, device=None,
) -> ErrorReport:
    device = resolve_device(device)
    acc = _Accum(n)
    acc.add(a, b, _simulate(a, b, n=n, t=t, fix_to_1=fix_to_1, device=device))
    return acc.report(t=t, fix_to_1=fix_to_1, exhaustive=exhaustive)


def _exhaustive_chunks(n: int, chunk: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    total = 1 << (2 * n)
    idx = np.arange(min(chunk, total), dtype=np.uint64)
    for start in range(0, total, chunk):
        cur = idx[: min(chunk, total - start)] + np.uint64(start)
        yield (cur >> np.uint64(n)), (cur & np.uint64((1 << n) - 1))


def exhaustive_eval(
    n: int, t: int, *, fix_to_1: bool = True, chunk: int = 1 << 22, device=None
) -> ErrorReport:
    """Exhaustive metric evaluation over all 2^{2n} input pairs (n <= 14)."""
    if 2 * n > 28:
        raise ValueError(f"exhaustive over 2^{2 * n} pairs is infeasible here; use mc_eval")
    device = resolve_device(device)
    acc = _Accum(n)
    for a, b in _exhaustive_chunks(n, chunk):
        acc.add(a, b, _simulate(a, b, n=n, t=t, fix_to_1=fix_to_1, device=device))
    return acc.report(t=t, fix_to_1=fix_to_1, exhaustive=True)


def mc_eval(
    n: int,
    t: int,
    *,
    samples: int = 1 << 22,
    fix_to_1: bool = True,
    seed: int = 0,
    chunk: int = 1 << 22,
    pdf_a=None,
    pdf_b=None,
    device=None,
) -> ErrorReport:
    """Monte-Carlo metric estimation (paper Section V-C methodology).

    ``pdf_a``/``pdf_b`` optionally give a measured input PDF (length 2^n,
    paper Section IV-B MED definition); default is uniform.  The samples
    are drawn on the host exactly as the reference draws them, so both
    packages see the same pairs for the same seed.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    acc = _Accum(n)
    done = 0
    while done < samples:
        cur = min(chunk, samples - done)
        if pdf_a is None:
            a = rng.integers(0, 1 << n, size=cur, dtype=np.uint64)
        else:
            a = rng.choice(1 << n, size=cur, p=pdf_a).astype(np.uint64)
        if pdf_b is None:
            b = rng.integers(0, 1 << n, size=cur, dtype=np.uint64)
        else:
            b = rng.choice(1 << n, size=cur, p=pdf_b).astype(np.uint64)
        acc.add(a, b, _simulate(a, b, n=n, t=t, fix_to_1=fix_to_1, device=device))
        done += cur
    return acc.report(t=t, fix_to_1=fix_to_1, exhaustive=False)
