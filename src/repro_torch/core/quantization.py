"""Integer quantization bridging real tensors to the n-bit multiplier.

Counterpart of ``repro/core/quantization.py``: symmetric sign-magnitude
quantization with absmax calibration, and the straight-through fake
quantizer used for approximate-aware training.

``quantize`` bit-matches the reference because it runs the same float32
operations in the same order: ``x / scale``, round half to even
(``torch.round``), clip; the scale is ``max(amax, 1e-12) / qmax`` in f32,
a true division on every device.
Magnitudes come back as int32 (the reference's uint32 values, which are
below 2^31 for every supported bit-width) and signs as int8.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QuantParams", "calibrate_absmax", "quantize", "dequantize", "fake_quant"]


class QuantParams(NamedTuple):
    scale: torch.Tensor  # f32, broadcastable to the tensor
    bits: int  # magnitude bit-width n (sign carried separately)


def _const(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``value`` with ``like``'s dtype and device."""
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


def calibrate_absmax(x: torch.Tensor, *, bits: int, dim=None) -> QuantParams:
    if dim is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=dim, keepdim=True)
    # qmax as a tensor on the device: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which can differ in the last bit.
    # torch.full fills on the device; torch.tensor would copy from the
    # host and synchronise the stream on every call.
    qmax = _const((1 << bits) - 1, amax)
    scale = torch.clamp_min(amax, 1e-12) / qmax
    return QuantParams(scale=scale.to(torch.float32), bits=bits)


def quantize(x: torch.Tensor, qp: QuantParams) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (magnitude int32 in [0, 2^bits), sign int8 in {-1, 0, 1})."""
    qmax = (1 << qp.bits) - 1
    # jnp promotes a bf16 tensor against the float32 scale; torch would
    # divide in bf16, since a 0-d tensor does not take part in promotion
    x = x.to(torch.promote_types(x.dtype, qp.scale.dtype))
    q = torch.clamp(torch.round(x / qp.scale), -qmax, qmax)
    return q.abs().to(torch.int32), torch.sign(q).to(torch.int8)


def dequantize(mag: torch.Tensor, sign: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    return mag.to(torch.float32) * sign.to(torch.float32) * qp.scale


class _SteRound(torch.autograd.Function):
    """Round forward, identity backward (the straight-through estimator)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant(x: torch.Tensor, *, bits: int, dim=None) -> torch.Tensor:
    """Straight-through fake quantization (QAT substrate)."""
    qp = calibrate_absmax(x.detach(), bits=bits, dim=dim)
    r = _SteRound.apply(x / qp.scale)
    # maximum/minimum rather than clamp: like the reference's jnp.clip they
    # split the gradient at a tie, which the absmax element always is
    qmax = _const((1 << bits) - 1, r)
    q = torch.minimum(torch.maximum(r, -qmax), qmax)
    return q * qp.scale
