"""The paper's split-word accumulate-and-shift recurrence, in torch.

Counterpart of ``repro/engine/recurrence.py``: the n-cycle sequential
multiplication with the accumulator split at ``t`` into an LSP word
(t bits) and an MSP word (n - t + 1 bits, including the adder carry-out
S_n).  Exact and approximate multipliers are the same recurrence; the
approximate one defers the LSP carry-out by one clock (the segmented
carry chain).

torch has no ``>>``, ``<<`` or ``+`` on ``torch.uint32`` on the CPU, so
the words are carried in int64 and every word stays below 2^32 by
construction (n <= 32).  This body is the plain version of the CUDA
``seqmul_matmul`` kernel, whose per-product loop repeats it line for line
(``kernels/csrc/seqmul_matmul.cu``).
"""

from __future__ import annotations

import torch

__all__ = ["MAX_N", "validate_nt", "seqmul_recurrence", "pack_u32"]

MAX_N = 32


def validate_nt(n: int, t: int) -> None:
    """Accept 1 <= n <= MAX_N with 1 <= t <= n-1, and t=1 at n=1 (the
    degenerate split: one cycle never produces an LSP carry)."""
    if not (1 <= n <= MAX_N):
        raise ValueError(f"bit-width n={n} out of supported range [1, {MAX_N}]")
    if not (1 <= t <= max(1, n - 1)):
        bound = "t == 1 (degenerate split)" if n == 1 else f"1 <= t <= n-1={n - 1}"
        raise ValueError(f"splitting point t={t} for n={n} must satisfy {bound}")


def seqmul_recurrence(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    n: int,
    t: int,
    approx: bool,
    fix_to_1: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the n-cycle recurrence elementwise over integer words.

    Args:
      a, b: multiplier and multiplicand, integer tensors of one shape with
        values in [0, 2**n).  They are widened to int64.
      n, t: bit-width and splitting point.
      approx: defer the LSP carry-out by one cycle.
      fix_to_1: on a final-cycle LSP carry-out, force product bits
        [0, n+t) to 1.  Ignored for the exact multiplier.

    Returns:
      ``(lo, s_lsp, s_msp, c_last)`` int64 words: ``lo`` holds product bits
      [0, n-1), ``s_lsp``/``s_msp`` the final accumulator (product bits
      [n-1, 2n]) and ``c_last`` the final LSP carry-out (0 when exact).
    """
    validate_nt(n, t)
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    m_t = (1 << t) - 1
    zero = torch.zeros_like(a)
    s_lsp, s_msp, c_ff, lo = zero, zero, zero, zero
    for j in range(n):
        m = torch.where(((b >> j) & 1).bool(), a, zero)
        # augend = S^{j-1} >> 1 (bit t-1 of the LSP receives the MSP's LSB)
        aug_lsp = (s_lsp >> 1) | ((s_msp & 1) << (t - 1))
        aug_msp = s_msp >> 1
        lsum = aug_lsp + (m & m_t)  # t+1 bits
        c_out = lsum >> t  # this cycle's LSP carry-out
        c_in = c_ff if approx else c_out
        s_msp = aug_msp + (m >> t) + c_in
        lo = lo | ((lsum & 1) << j)
        s_lsp = lsum & m_t
        c_ff = c_out
    lo = lo & ((1 << (n - 1)) - 1) if n > 1 else zero
    if approx and fix_to_1:
        hit = c_ff.bool()
        lo = torch.where(hit, torch.full_like(lo, (1 << (n - 1)) - 1 if n > 1 else 0), lo)
        s_lsp = torch.where(hit, torch.full_like(s_lsp, m_t), s_lsp)
        s_msp = torch.where(hit, s_msp | 1, s_msp)
    return lo, s_lsp, s_msp, c_ff


def pack_u32(lo, s_lsp, s_msp, *, n: int, t: int) -> torch.Tensor:
    """The product value ``lo + 2^(n-1)·(s_lsp + 2^t·s_msp)`` as int64
    (the reference packs it into a uint32, valid for 2n <= 31)."""
    return lo + ((s_lsp + (s_msp << t)) << (n - 1))
