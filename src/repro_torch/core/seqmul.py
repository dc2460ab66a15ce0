"""The paper's sequential multiplier, elementwise, in torch.

Counterpart of ``repro/core/seqmul.py``: the n-cycle accumulate-and-shift
multiplication with the accumulator split at ``t`` (the segmented carry
chain), vectorized over tensors of any shape.  The recurrence body is
``engine.recurrence``, which carries its words in int64 because torch on
the CPU has no shifts or adds on ``torch.uint32``; operands in and words
out are ``torch.uint32``, the reference's dtype.  Supported bit-widths are
1 <= n <= 32; products are assembled on the host in numpy uint64.

On the TPU the reference runs this as jnp code that XLA fuses, outside any
Pallas kernel.  Its counterpart here is this plain torch body on the
operands' device, as ``torch.matmul`` is for a plain GEMM.  It is not the
elementwise CUDA kernels' counterpart: those live in
``kernels/seqmul_kernel.py``, and ``engine.multiply`` and
``core.error_metrics`` route to them; the kernels' plain versions there
reuse this module's recurrence and packed body (:func:`packed_u32`).
Bit-exactness against the paper's boolean equations (``core.boolean_ref``)
and against ``repro.core.seqmul`` is asserted in
``tests/test_torch_seqmul.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.engine.recurrence import MAX_N, pack_u32, seqmul_recurrence, validate_nt

__all__ = [
    "ProductWords",
    "seq_mul_words",
    "seq_mul_exact_u32",
    "seq_mul_approx_u32",
    "assemble_product_u64",
    "MAX_N",
]


class ProductWords(NamedTuple):
    """A 2n-bit product in split-word form (all ``torch.uint32``).

    The product value is ``lo + 2**(n-1) * (s_lsp + 2**t * s_msp)``:
    ``lo`` holds product bits [0, n-1), ``s_lsp``/``s_msp`` the final
    accumulator S^{n-1} (product bits [n-1, 2n]), and ``c_last`` the LSP
    carry-out of the final accumulation, Ĉ_{t-1}^{n-1} (always 0 for the
    exact multiplier), which drives the fix-to-1 multiplexers.
    """

    lo: torch.Tensor
    s_lsp: torch.Tensor
    s_msp: torch.Tensor
    c_last: torch.Tensor


def operands(a, b) -> tuple[torch.Tensor, torch.Tensor]:
    """Both operands as tensors on one device.  A tensor keeps its dtype
    and device; anything else becomes a uint32 tensor (the reference's
    ``jnp.asarray(x, jnp.uint32)``) on the other operand's device, or on
    the CPU when neither is a tensor.  Two tensors on different devices
    raise."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    device = next((x.device for x in (a, b) if isinstance(x, torch.Tensor)), torch.device("cpu"))

    def as_tensor(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.array(x, np.uint32)).to(device)

    return as_tensor(a), as_tensor(b)


def seq_mul_words(
    a,
    b,
    *,
    n: int,
    t: int,
    approx: bool,
    fix_to_1: bool = True,
) -> ProductWords:
    """Run the n-cycle sequential multiplication elementwise.

    Args:
      a: multiplier, integer tensor (or array-like), any shape, values in
        [0, 2**n).
      b: multiplicand, the same shape as ``a``.
      n, t: operand bit-width and splitting point (the LSP is t bits wide).
        With ``approx=False`` the result does not depend on ``t``.
      approx: defer the LSP carry-out by one cycle (segmented carry chain).
      fix_to_1: on a final-cycle LSP carry-out, force product bits [0, n+t)
        to 1.  Ignored for the exact multiplier.
    """
    validate_nt(n, t)
    a, b = operands(a, b)
    words = seqmul_recurrence(a, b, n=n, t=t, approx=approx, fix_to_1=fix_to_1)
    return ProductWords(*(w.to(torch.uint32) for w in words))


def _u64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.uint64)


def assemble_product_u64(words: ProductWords, *, n: int, t: int) -> np.ndarray:
    """Host-side assembly of the 2n-bit product into numpy uint64."""
    lo = _u64(words.lo)
    s = _u64(words.s_lsp) + (_u64(words.s_msp) << np.uint64(t))
    return lo + (s << np.uint64(n - 1))


def packed_u32(a: torch.Tensor, b: torch.Tensor, *, n: int, t: int, approx: bool,
               fix_to_1: bool) -> torch.Tensor:
    """The packed product of two tensors on one device, with no checks:
    the one body of ``seq_mul_*_u32``, of ``engine.multiply``'s reference
    backend and of the ``seqmul_packed`` kernel's plain version."""
    lo, s_lsp, s_msp, _ = seqmul_recurrence(a, b, n=n, t=t, approx=approx, fix_to_1=fix_to_1)
    return pack_u32(lo, s_lsp, s_msp, n=n, t=t).to(torch.uint32)


def _packed(a, b, n, t, approx, fix_to_1):
    if 2 * n > 31:
        raise ValueError(f"packed u32 product needs 2n <= 31 bits, got n={n}; use seq_mul_words")
    validate_nt(n, t)
    a, b = operands(a, b)
    return packed_u32(a, b, n=n, t=t, approx=approx, fix_to_1=fix_to_1)


def seq_mul_exact_u32(a, b, *, n: int) -> torch.Tensor:
    """Exact sequential product packed into a single uint32 (n <= 15)."""
    return _packed(a, b, n, max(1, n // 2), approx=False, fix_to_1=False)


def seq_mul_approx_u32(a, b, *, n: int, t: int, fix_to_1: bool = True) -> torch.Tensor:
    """Approximate (segmented carry chain) product packed in uint32 (n <= 15)."""
    return _packed(a, b, n, t, approx=True, fix_to_1=fix_to_1)
