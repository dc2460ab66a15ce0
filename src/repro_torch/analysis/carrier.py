"""The carrier marker: "this value lives in a b-bit word of the CUDA kernel".

``carrier(x, bits, signed, where)`` is an identity op (it returns a copy
of ``x``) registered as the custom op ``repro_torch::carrier``, so it
stands in the aten graph as one node.  The certifier
(``analysis.interp``) holds the traced envelope of ``x`` to the carrier's
range, ``[0, 2^bits - 1]`` or ``[-2^(bits-1), 2^(bits-1) - 1]``, and
names ``where`` in its finding.  A kernel's carrier-faithful body
(``audit_body`` in each module of ``kernels/``) computes in int64, as
the plain versions do, and marks every value the ``.cu`` file holds in a
narrower word: an int32 accumulator, an int16 lane, a 24-bit field of a
packed word, the n + 1 planes of the recurrence's state.
"""

from __future__ import annotations

import torch

__all__ = ["carrier", "carrier_op"]

_OP = None


def carrier_op():
    """The registered op (registered at first use, once per process)."""
    global _OP
    if _OP is None:
        if not hasattr(torch.ops.repro_torch, "carrier"):
            @torch.library.custom_op("repro_torch::carrier", mutates_args=())
            def _carrier(x: torch.Tensor, bits: int, signed: bool, where: str) -> torch.Tensor:
                return x.clone()

            @_carrier.register_fake
            def _(x, bits, signed, where):
                return torch.empty_like(x)
        _OP = torch.ops.repro_torch.carrier.default
    return _OP


def carrier(x: torch.Tensor, bits: int, signed: bool, where: str) -> torch.Tensor:
    """``x``, marked as held in a ``bits``-bit (``signed``) word at ``where``."""
    return carrier_op()(x, bits, signed, where)


def carrier_range(bits: int, signed: bool) -> tuple[float, float]:
    if signed:
        return (-float(1 << (bits - 1)), float((1 << (bits - 1)) - 1))
    return (0.0, float((1 << bits) - 1))
