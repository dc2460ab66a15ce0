"""The dispatch layer for approximate multiplication.

Counterpart of ``repro/engine/dispatch.py``.  :func:`matmul` quantizes,
looks the mode up in the registry (``engine.modes``), picks a backend
(``engine.policy``) and applies the straight-through gradient rule to
non-differentiable modes as a ``torch.autograd.Function`` whose backward
is the exact matmul gradient.

Backends: ``reference`` (plain PyTorch bodies), ``cuda`` (the Hopper
kernels; an explicit request for a mode without one raises), ``auto``
(``cuda`` for CUDA tensors on sm_90 where the mode has a kernel, else
``reference``).

:func:`multiply` is the elementwise counterpart on integer magnitudes: the
``seqmul_packed`` kernel (``kernels.seqmul_kernel``) for ``cuda``,
``core.seqmul`` for ``reference``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.engine import modes as _modes
from repro_torch.engine import policy as _policy

__all__ = ["BACKENDS", "PACKED_U32_MAX_2N", "matmul", "multiply", "resolve_backend"]

BACKENDS = _policy.BACKENDS

# Per-mode bit-width ceilings, validated eagerly at dispatch time:
#   bitexact  gathers a (2^n, 2^n) product table (uint16 entries at n <= 8);
#   seqmul    assembles 2n-bit products in 32-bit registers (exact, n <= 12);
#   inject    packs quantized magnitudes into int16 lanes (|q| < 2^15);
#   fakequant symmetric integer quantization in f32 (exact for n <= 23).
_MODE_MAX_N = {"bitexact": 8, "lowrank": 8, "seqmul": 12, "inject": 15, "fakequant": 23}

PACKED_U32_MAX_2N = 31  # packed single-word product limit (the elementwise multiply)


def _resolve_nt(n, t):
    """Fill unspecified (n, t) from the accuracy-configuration controller."""
    from repro_torch.engine import config as _config

    if n is None:
        n = _config.DEFAULT_N
    if t is None:
        t = _config.default_t(n)
    return n, t


def _validate_mode_nt(mode: str, n: int, t: int) -> None:
    """Eager (n, t) validation with the mode named in the error."""
    from repro_torch.engine.recurrence import validate_nt

    try:
        validate_nt(n, t)
    except ValueError as e:
        raise ValueError(f"mode {mode!r}: {e}") from None
    max_n = _MODE_MAX_N.get(mode)
    if max_n is not None and n > max_n:
        raise ValueError(
            f"mode {mode!r} supports bit-widths n <= {max_n}, got n={n} "
            f"(use mode='seqmul' up to n=12; wider operands go through "
            f"kernels.seqmul_kernel.seqmul_words)"
        )


def resolve_backend(backend: str, spec: _modes.ModeSpec, device: torch.device) -> str:
    """Map ``auto`` onto a concrete backend for ``spec`` on ``device``;
    an explicit ``cuda`` for a mode with no kernel raises."""
    if backend == "cuda" and spec.cuda is None:
        raise ValueError(
            f"mode {spec.name!r} has no CUDA kernel; backend='cuda' was requested "
            f"explicitly (use backend='auto' for its reference body)"
        )
    resolved = _policy.resolve_backend(backend, device)
    if resolved == "cuda" and spec.cuda is None:
        return "reference"
    return resolved


class _StraightThrough(torch.autograd.Function):
    """Forward ``impl(x, w, p, *extra)``; backward = exact-matmul grads
    (``g @ w.T``, ``x.T @ g``); ``extra`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, impl, p, *extra):
        ctx.save_for_backward(x, w)
        ctx.n_extra = len(extra)
        return impl(x, w, p, *extra)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.float32)
        return (g @ w.T, x.T @ g, None, None) + (None,) * ctx.n_extra


def matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    n: Optional[int] = None,
    t: Optional[int] = None,
    fix_to_1: bool = True,
    mode: str = "bitexact",
    rank: int = 8,
    generator: Optional[torch.Generator] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Approximate GEMM: x (M, K) @ w (K, N) -> (M, N) f32.

    ``n``/``t`` left ``None`` are resolved by ``engine.config`` (the
    ``balanced`` tier's split at ``DEFAULT_N``).  Raises ``ValueError`` for
    an unknown mode or backend, an explicit ``cuda`` backend on a mode
    without a kernel or on a CPU tensor, and a stochastic mode called
    without a ``generator``.
    """
    n, t = _resolve_nt(n, t)
    spec = _modes.get_mode(mode)
    _validate_mode_nt(mode, n, t)
    resolved = resolve_backend(backend, spec, x.device)
    if spec.needs_key and generator is None:
        raise ValueError(f"mode {mode!r} needs a torch.Generator")
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    if resolved == "cuda":
        from repro_torch.engine import config as _config

        _config.kernel_tiles(mode, n, t, x.shape[0], rank)
    p = _modes.GemmParams(n=n, t=t, fix_to_1=fix_to_1, rank=rank)
    extra = spec.prepare(x, w, p, generator) if spec.prepare is not None else ()
    impl = spec.cuda if resolved == "cuda" else spec.reference
    if spec.differentiable:
        return impl(x, w, p, *extra)
    return _StraightThrough.apply(x, w, impl, p, *extra)


def _check_multiply(n: int, t: int, approx: bool) -> None:
    """The eager checks of :func:`multiply`, with its mode named in the error."""
    mode_name = "seqmul_approx" if approx else "seqmul_exact"
    _validate_mode_nt(mode_name, n, t)
    if 2 * n > PACKED_U32_MAX_2N:
        raise ValueError(
            f"multiply (mode {mode_name!r}) packs the 2n-bit product into one "
            f"uint32, which requires 2n <= {PACKED_U32_MAX_2N} (got n={n}, "
            f"2n={2 * n}); use kernels.seqmul_kernel.seqmul_words for "
            f"the two-word (low, high) output at n up to 16"
        )


def multiply(
    a,
    b,
    *,
    n: Optional[int] = None,
    t: Optional[int] = None,
    approx: bool = True,
    fix_to_1: bool = True,
    backend: str = "auto",
) -> torch.Tensor:
    """Elementwise (approximate) product of integer magnitudes in [0, 2^n),
    any shape; returns the packed 2n-bit product as ``torch.uint32``
    (requires 2n <= 31).

    ``n``/``t`` default to the controller's resolution (see ``matmul``).
    ``auto`` runs the ``seqmul_packed`` kernel for CUDA tensors on sm_90
    and ``core.seqmul`` for CPU tensors; an explicit ``cuda`` on a CPU
    tensor raises.  The reference's ``REPRO_STATIC_AUDIT`` gate has no
    counterpart: the eager checks above are the whole integer envelope
    (``engine.config.within_envelope``) of the elementwise modes.
    """
    from repro_torch.core import seqmul as _seqmul

    n, t = _resolve_nt(n, t)
    _check_multiply(n, t, approx)
    a, b = _seqmul.operands(a, b)
    resolved = _policy.resolve_backend(backend, a.device)
    if resolved == "cuda":
        from repro_torch.kernels.seqmul_kernel import packed_kernel

        return packed_kernel(a, b, n=n, t=t, approx=approx, fix_to_1=fix_to_1)
    if approx:
        return _seqmul.packed_u32(a, b, n=n, t=t, approx=True, fix_to_1=fix_to_1)
    # the reference's exact path splits at max(1, n // 2); the exact product
    # does not depend on t
    return _seqmul.packed_u32(a, b, n=n, t=max(1, n // 2), approx=False, fix_to_1=False)
