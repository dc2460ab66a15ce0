"""Mode registry for the approximate-GEMM engine.

Counterpart of ``repro/engine/modes.py``.  Every execution mode is a
registered :class:`ModeSpec` carrying its reference body (plain PyTorch,
any device) and, where one exists, its CUDA body (the hand-written Hopper
kernel in ``repro_torch.kernels``).  ``repro_torch.engine.matmul`` looks
the mode up here and dispatches.

Registered modes
----------------
``exact``      plain f32 matmul (the baseline).
``bitexact``   every scalar product from the (2^n, 2^n) product table
               (n <= 8); CUDA body: ``kernels.lut_matmul``.
``seqmul``     the split-word recurrence per product (n <= 12); CUDA
               body: ``kernels.seqmul_matmul``.
``inject``     quantized exact GEMM + moment-matched Gaussian error;
               CUDA body: ``kernels.packed_matmul`` (two int16 lanes per
               word), noise added outside the kernel.
``fakequant``  straight-through fake quantization of both operands.

``lowrank`` is not registered in this slice: asking for it raises and
names the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import quantization
from repro_torch.engine import artifacts
from repro_torch.kernels.lut_matmul import lut_matmul, lut_matmul_plain
from repro_torch.kernels.packed_matmul import pack_i16_pairs, packed_matmul
from repro_torch.kernels.seqmul_matmul import seqmul_matmul, seqmul_matmul_plain

__all__ = [
    "GemmParams",
    "ModeSpec",
    "register_mode",
    "get_mode",
    "list_modes",
    "default_generator",
    "quantize_operands",
]

# modes of the JAX package that a later slice of the port brings over
NOT_PORTED = {
    "lowrank": "ROADMAP.md, 'TPU kernels to port' item 4 (lowrank_matmul)",
}


class GemmParams(NamedTuple):
    """Static configuration threaded to every mode body."""

    n: int
    t: int
    fix_to_1: bool
    rank: int


@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """One registered execution mode.

    ``reference``/``cuda`` have signature ``(x, w, p, *extra) -> out`` on
    f32 2-D operands; ``extra`` is what ``prepare`` returned (f32 tensors
    that receive no gradient).  ``cuda=None`` means the reference body
    runs on every backend.  ``differentiable=False`` makes the engine wrap
    the forward in a straight-through ``autograd.Function`` whose backward
    is the exact matmul gradient.
    """

    name: str
    reference: Callable
    cuda: Optional[Callable] = None
    prepare: Optional[Callable] = None  # (x, w, p, generator) -> tuple of f32 tensors
    needs_key: bool = False
    differentiable: bool = True
    description: str = ""


_REGISTRY: dict[str, ModeSpec] = {}


def register_mode(spec: ModeSpec) -> ModeSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"mode {spec.name!r} is already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_mode(name: str) -> ModeSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in NOT_PORTED:
            raise ValueError(
                f"mode {name!r} is not ported to PyTorch yet; {NOT_PORTED[name]} "
                f"brings it over"
            ) from None
        raise ValueError(f"unknown mode {name!r}; registered modes: {list_modes()}") from None


def list_modes() -> list[str]:
    return sorted(_REGISTRY)


def default_generator(mode: str, generator, device: torch.device):
    """The generator a model layer hands to ``matmul`` for ``mode``.

    Mirrors ``repro.engine.modes.resolve_key``: a stochastic mode called
    without a generator draws from a fixed seed-0 generator, so
    evaluation is deterministic (``matmul`` itself stays strict).
    """
    if get_mode(mode).needs_key and generator is None:
        return torch.Generator(device=device).manual_seed(0)
    return generator


# ------------------------------------------------------------------ helpers
def quantize_operands(x: torch.Tensor, w: torch.Tensor, n: int):
    """Sign-magnitude absmax quantization of both GEMM operands.

    Returns ``((mag_x, sign_x), (mag_w, sign_w), scale)``; calibration
    sees detached tensors (scales are data, not parameters).
    """
    qx = quantization.calibrate_absmax(x.detach(), bits=n)
    qw = quantization.calibrate_absmax(w.detach(), bits=n)
    mx, sx = quantization.quantize(x, qx)
    mw, sw = quantization.quantize(w, qw)
    return (mx, sx), (mw, sw), qx.scale * qw.scale


# ------------------------------------------------------------ mode bodies
def _exact_ref(x, w, p):
    return x @ w


def _bitexact_ref(x, w, p):
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, p.n)
    lut = artifacts.product_lut_u16(p.n, p.t, p.fix_to_1, x.device)
    return lut_matmul_plain(lut, mx, sx, mw, sw, n=p.n) * scale


def _bitexact_cuda(x, w, p):
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, p.n)
    lut = artifacts.product_lut_u16(p.n, p.t, p.fix_to_1, x.device)
    out = lut_matmul(lut, mx.to(torch.uint8), sx, mw.to(torch.uint8), sw, n=p.n)
    return out * scale


def _seqmul_ref(x, w, p):
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, p.n)
    acc = seqmul_matmul_plain(mx, sx, mw, sw, n=p.n, t=p.t, fix_to_1=p.fix_to_1)
    return acc * scale


def _seqmul_cuda(x, w, p):
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, p.n)
    out = seqmul_matmul(
        mx.to(torch.int16), sx, mw.to(torch.int16), sw,
        n=p.n, t=p.t, fix_to_1=p.fix_to_1,
    )
    return out * scale


def _inject_prepare(x, w, p, generator):
    """Draw the moment-matched noise, shape (M, N)."""
    mean, std = artifacts.error_moments(p.n, p.t, p.fix_to_1)
    k_dim = x.shape[-1]
    z = torch.randn(
        (x.shape[0], w.shape[-1]), generator=generator, dtype=torch.float32, device=x.device
    )
    return (mean * k_dim + std * math.sqrt(k_dim) * z,)


def _inject_ref(x, w, p, noise):
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, p.n)
    ax = mx.to(torch.float32) * sx.to(torch.float32)
    aw = mw.to(torch.float32) * sw.to(torch.float32)
    return (ax @ aw + noise) * scale


def _inject_cuda(x, w, p, noise):
    """Draft-tier path: the quantized exact GEMM on int16 lane pairs,
    then the noise.  Integer-exact, so equal to the reference body
    wherever the reference's float32 sums are exact."""
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, p.n)
    pa = pack_i16_pairs(mx * sx.to(torch.int32), dim=1)
    pb = pack_i16_pairs(mw * sw.to(torch.int32), dim=0)
    out = packed_matmul(pa, pb, n=p.n)
    return (out + noise) * scale


def _fakequant_ref(x, w, p):
    return quantization.fake_quant(x, bits=p.n) @ quantization.fake_quant(w, bits=p.n)


register_mode(ModeSpec(
    name="exact",
    reference=_exact_ref,
    description="plain f32 matmul (baseline)",
))
register_mode(ModeSpec(
    name="bitexact",
    reference=_bitexact_ref,
    cuda=_bitexact_cuda,
    differentiable=False,
    description="faithful paper semantics via the (2^n, 2^n) product LUT",
))
register_mode(ModeSpec(
    name="seqmul",
    reference=_seqmul_ref,
    cuda=_seqmul_cuda,
    differentiable=False,
    description="paper recurrence per product inside the GEMM (no LUT, n <= 12)",
))
register_mode(ModeSpec(
    name="inject",
    reference=_inject_ref,
    prepare=_inject_prepare,
    cuda=_inject_cuda,
    needs_key=True,
    differentiable=False,
    description="moment-matched stochastic error injection (O(1) at scale)",
))
register_mode(ModeSpec(
    name="fakequant",
    reference=_fakequant_ref,
    description="straight-through fake quantization (QAT substrate)",
))
