"""Int8 error-feedback gradient compression.

Counterpart of ``repro/optim/compress.py``.  At 1000-node scale the
cross-pod gradient all-reduce is the bandwidth-critical collective;
compressing it 4x (f32 -> int8) with an error-feedback residual keeps
convergence unbiased (the quantization error is replayed into the next
step's gradient).  On one device the semantics are the same: the step
applies the gradient as it would arrive after the all-reduce, and the
residual rides in the train state.

Gradients and residuals are lists with one flat float32 tensor per leaf
of the reference's parameter tree (``models.registry.reference_leaves``),
so the per-tensor scale is taken over the same values as the reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

__all__ = ["CompressState", "compress_grads", "init_state"]


class CompressState(NamedTuple):
    residual: list  # per reference leaf: flat f32


def init_state(numels: Sequence[int], device) -> CompressState:
    return CompressState([torch.zeros((n,), dtype=torch.float32, device=device) for n in numels])


def _q(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # a 0-d divisor on the device: CUDA divides by a host scalar as a
    # multiply by its reciprocal
    scale = x.abs().amax() / torch.full((), 127.0, dtype=torch.float32, device=x.device)
    code = torch.round(x / torch.clamp_min(scale, 1e-12)).to(torch.int8)
    return code, scale


@torch.no_grad()
def compress_grads(grads: Sequence[torch.Tensor], state: CompressState):
    """Returns (decompressed grads as would arrive post-allreduce, new state,
    metrics).  Error feedback: e' = (g + e) - dq(q(g + e))."""
    deq, res = [], []
    for g, e in zip(grads, state.residual):
        x = g.to(torch.float32) + e
        code, scale = _q(x)
        d = code.to(torch.float32) * scale
        deq.append(d)
        res.append(x - d)
    err = None
    for r in res:
        part = torch.sum(torch.square(r))
        err = part if err is None else err + part
    return deq, CompressState(res), {"compress_residual_sq": err}
