"""The paper's multiplier as an elementwise pass over tensors of any shape.

Counterpart of ``repro/kernels/seqmul_kernel.py``.  :func:`seqmul_packed`
(``engine.multiply``'s kernel) returns the packed 2n-bit product in one
uint32 (2n <= 31); :func:`seqmul_words` returns it as two uint32 words,
``low`` = product bits [0, n) and ``high`` = bits [n, 2n], so the product
is ``low + (high << n)`` for any n <= 16 (the paper's n = 16);
``core.error_metrics`` simulates its products through it.  Both run
the CUDA kernels of ``csrc/seqmul_kernel.cu`` for CUDA tensors and their
plain versions :func:`seqmul_packed_plain` / :func:`seqmul_words_plain`
for CPU tensors.  The TPU's ``block_rows`` and ``interpret`` knobs have no
counterpart: the kernels make one flat pass with no padding.

Operands are integer tensors of one shape (0-d and empty included) with
values in [0, 2^n), the reference's contract: the plain versions carry
int64 words, where the kernels and the reference wrap uint32 words, so an
operand outside that range may give another result.  Outputs are
``torch.uint32`` of the operands' shape.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.seqmul import packed_u32
from repro_torch.engine.recurrence import seqmul_recurrence, validate_nt
from repro_torch.kernels.build import CudaKernel, audit_gate

__all__ = [
    "PACKED_KERNEL", "WORDS_KERNEL", "WORDS_MAX_N", "audit_body_packed", "audit_body_words",
    "audit_trace_packed", "audit_trace_words", "packed_kernel", "seqmul_packed",
    "seqmul_packed_plain", "seqmul_words", "seqmul_words_plain",
]

WORDS_MAX_N = 16  # the two-word form's recurrence fits uint32 lanes up to here

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PACKED_KERNEL = CudaKernel(
    "seqmul_packed", "seqmul_packed_launch", [_P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    source="seqmul_kernel",
)
WORDS_KERNEL = CudaKernel(
    "seqmul_words", "seqmul_words_launch", [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    source="seqmul_kernel",
)


def _check_packed(n: int, t: int) -> None:
    validate_nt(n, t)
    if 2 * n > 31:
        raise ValueError(
            f"packed kernel supports 2n <= 31 bits (got n={n}, 2n={2 * n}); "
            f"use seqmul_words for the two-word (low, high) output"
        )


def _check_words(n: int, t: int) -> None:
    validate_nt(n, t)
    if n > WORDS_MAX_N:
        raise ValueError(
            f"two-word output holds bits [0, 2n] across two uint32 words "
            f"with the recurrence in uint32 lanes, which needs n <= 16 "
            f"(got n={n})"
        )


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, x in (("a", a), ("b", b)):
        if x.is_floating_point() or x.is_complex():
            raise TypeError(f"{name} has dtype {x.dtype}, expected an integer dtype")
    if a.shape != b.shape:
        raise ValueError(f"a and b differ in shape: {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")


def seqmul_packed_plain(a, b, *, n: int, t: int, approx: bool = True,
                        fix_to_1: bool = True) -> torch.Tensor:
    """Plain PyTorch version: ``core.seqmul``'s recurrence and packed word."""
    _check_packed(n, t)
    _check_operands(a, b)
    return packed_u32(a, b, n=n, t=t, approx=approx, fix_to_1=fix_to_1)


def seqmul_words_plain(a, b, *, n: int, t: int, approx: bool = True,
                       fix_to_1: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the recurrence, then the reference's
    ``_split_words``: ``low = lo | (s & 1) << (n-1)``, ``high = s >> 1``
    with ``s = s_lsp + (s_msp << t)``."""
    _check_words(n, t)
    _check_operands(a, b)
    lo, s_lsp, s_msp, _ = seqmul_recurrence(a, b, n=n, t=t, approx=approx, fix_to_1=fix_to_1)
    s = s_lsp + (s_msp << t)
    low = lo | ((s & 1) << (n - 1))
    return low.to(torch.uint32), (s >> 1).to(torch.uint32)


def packed_kernel(a, b, *, n: int, t: int, approx: bool = True,
                  fix_to_1: bool = True) -> torch.Tensor:
    """The ``seqmul_packed`` kernel on CUDA tensors, with (n, t) checked by
    the caller (``engine.multiply`` checks them under its mode's name)."""
    _check_operands(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"packed_kernel needs CUDA tensors, got {a.device}")
    audit_gate(PACKED_KERNEL.name, "packed_single", n, t)
    a, b = (x.to(torch.uint32).contiguous() for x in (a, b))
    out = torch.empty(a.shape, dtype=torch.uint32, device=a.device)
    if out.numel():
        PACKED_KERNEL.launch(a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             out.numel(), n, t, int(approx), int(fix_to_1))
    return out


def seqmul_packed(a, b, *, n: int, t: int, approx: bool = True,
                  fix_to_1: bool = True) -> torch.Tensor:
    """Elementwise product of integer tensors in [0, 2^n), packed into one
    uint32 (2n <= 31): the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if a.device.type == "cpu":
        return seqmul_packed_plain(a, b, n=n, t=t, approx=approx, fix_to_1=fix_to_1)
    _check_packed(n, t)
    return packed_kernel(a, b, n=n, t=t, approx=approx, fix_to_1=fix_to_1)


def seqmul_words(a, b, *, n: int, t: int, approx: bool = True,
                 fix_to_1: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Elementwise product of integer tensors in [0, 2^n) as ``(low, high)``
    uint32 words, ``low`` = bits [0, n), ``high`` = bits [n, 2n] (n <= 16):
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_words(n, t)
    _check_operands(a, b)
    if a.device.type == "cpu":
        return seqmul_words_plain(a, b, n=n, t=t, approx=approx, fix_to_1=fix_to_1)
    audit_gate(WORDS_KERNEL.name, "packed_words", n, t)
    a, b = (x.to(torch.uint32).contiguous() for x in (a, b))
    low = torch.empty(a.shape, dtype=torch.uint32, device=a.device)
    high = torch.empty_like(low)
    if low.numel():
        WORDS_KERNEL.launch(a.device, a.data_ptr(), b.data_ptr(), low.data_ptr(),
                            high.data_ptr(), low.numel(), n, t, int(approx), int(fix_to_1))
    return low, high


def _one_word(a, b, *, n: int, t: int, approx: bool, fix_to_1: bool):
    """The recurrence, its results marked with the uint32 words
    ``csrc/seqmul_kernel.cu`` holds them in (``seqmul_one``: lo and the
    one-word state W = s_lsp + 2^t s_msp)."""
    from repro_torch.analysis.carrier import carrier

    cu = "csrc/seqmul_kernel.cu"
    lo, s_lsp, s_msp, _ = seqmul_recurrence(a.to(torch.int64), b.to(torch.int64), n=n, t=t,
                                            approx=approx, fix_to_1=fix_to_1)
    w = carrier(s_lsp + (s_msp << t), 32, False, f"{cu}: W, the one-word state (unsigned)")
    return carrier(lo, 32, False, f"{cu}: lo, product bits [0, n-1) (unsigned)"), w


def audit_body_packed(a, b, *, n: int, t: int, approx: bool = True,
                      fix_to_1: bool = True) -> torch.Tensor:
    """``seqmul_packed_kernel``'s arithmetic for the certifier: the packed
    word ``lo + (W << (n-1))`` in a uint32.  Equal to
    :func:`seqmul_packed_plain` (as int64 values) wherever that is defined."""
    from repro_torch.analysis.carrier import carrier

    lo, w = _one_word(a, b, n=n, t=t, approx=approx, fix_to_1=fix_to_1)
    return carrier(lo + (w << (n - 1)), 32, False,
                   "csrc/seqmul_kernel.cu: the packed product word (unsigned)")


def audit_body_words(a, b, *, n: int, t: int, approx: bool = True,
                     fix_to_1: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """``seqmul_words_kernel``'s arithmetic for the certifier:
    ``low = lo | (W & 1) << (n-1)`` and ``high = W >> 1``, each a uint32."""
    from repro_torch.analysis.carrier import carrier

    cu = "csrc/seqmul_kernel.cu"
    lo, w = _one_word(a, b, n=n, t=t, approx=approx, fix_to_1=fix_to_1)
    low = carrier(lo | ((w & 1) << (n - 1)), 32, False, f"{cu}: low word (unsigned)")
    return low, carrier(w >> 1, 32, False, f"{cu}: high word (unsigned)")


def audit_trace_packed(*, n: int, t: int, size: int = 1024):
    """The certifier's contract of ``seqmul_packed``, past the wrapper's
    ``2n <= 31`` guard: operands in ``[0, 2^n - 1]``.  The packed word
    never wraps its uint32 (it tops out at 2^(2n) - 1); what binds is its
    output contract: consumers take the product as a non-negative int32
    payload, ``[0, 2^31 - 1]``, first broken at n = 16."""
    from repro_torch.analysis.spec import TraceSpec, ValueRange, sds

    q = ValueRange.quantized(n)
    return TraceSpec(
        name=f"kernel:seqmul_packed[n={n},t={t}]",
        fn=lambda a, b: audit_body_packed(a, b, n=n, t=t),
        args=[sds((size,), torch.int64), sds((size,), torch.int64)],
        ranges=[q, q],
        out_ranges=[ValueRange(0.0, float(2**31 - 1), int_valued=True)],
        out_contract_reason=("the packed single-word product is consumed as a non-negative "
                             "int32 payload, which requires 2n <= 31"),
    )


def audit_trace_words(*, n: int, t: int, size: int = 1024):
    """The certifier's contract of ``seqmul_words``: operands in
    ``[0, 2^n - 1]``; the (low, high) words stay inside their uint32s for
    every n <= 16."""
    from repro_torch.analysis.spec import TraceSpec, ValueRange, sds

    q = ValueRange.quantized(n)
    return TraceSpec(
        name=f"kernel:seqmul_words[n={n},t={t}]",
        fn=lambda a, b: audit_body_words(a, b, n=n, t=t),
        args=[sds((size,), torch.int64), sds((size,), torch.int64)],
        ranges=[q, q],
    )
