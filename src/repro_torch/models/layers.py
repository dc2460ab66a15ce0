"""Shared layers: RMSNorm, RoPE, dense (with the paper's multiplier), gated MLP.

Counterpart of ``repro/models/layers.py``.  Layers are plain functions
over parameter tensors; ``Ctx`` threads the config and the noise
generator through the stack without global state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ApproxConfig, ModelConfig
from repro_torch.engine import dispatch as _engine, modes as _engine_modes

__all__ = ["Ctx", "rms_norm", "rope", "dense", "mlp", "normal_init"]


@dataclasses.dataclass
class Ctx:
    """Call context: the config and an optional generator for the
    stochastic modes.  The reference folds a call-site counter into its
    PRNG key; a generator advances by itself, so each dense call draws
    fresh noise from it."""

    cfg: ModelConfig
    generator: Optional[torch.Generator] = None


# --------------------------------------------------------------------- init
def normal_init(shape, scale: float, dtype: torch.dtype, device: torch.device,
                generator: torch.Generator) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in f32 and cast, as ``layers._normal``."""
    z = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return (z * scale).to(dtype)


# ------------------------------------------------------------------- layers
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the reference's ``(1 + scale)`` gain (zero-init scales)."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def _rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S).  Rotates the two halves of D."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.to(torch.float32)[..., None] * freqs  # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------- approximate dense
def _approx_2d(x2: torch.Tensor, w: torch.Tensor, ap: ApproxConfig, generator) -> torch.Tensor:
    """One engine call; the mode registry owns the mode's semantics."""
    return _engine.matmul(
        x2.to(torch.float32),
        w.to(torch.float32),
        n=ap.n,
        t=ap.t,
        fix_to_1=ap.fix_to_1,
        mode=ap.mode,
        rank=ap.rank,
        generator=_engine_modes.default_generator(ap.mode, generator, x2.device),
        backend=ap.backend,
    )


def dense(x: torch.Tensor, w: torch.Tensor, ctx: Ctx, kind: str = "mlp") -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out), through the approximate multiplier
    when ``kind`` is targeted.  The engine works in f32; the result is
    cast back to the working dtype, as ``layers.dense`` does."""
    ap = ctx.cfg.approx
    if not ap.enabled or kind not in ap.targets:
        return x @ w.to(x.dtype)
    ap = ap.for_target(kind)
    lead = x.shape[:-1]
    out = _approx_2d(x.reshape(-1, x.shape[-1]), w, ap, ctx.generator)
    return out.reshape(*lead, w.shape[-1]).to(x.dtype)


def _gelu_tanh(v: torch.Tensor) -> torch.Tensor:
    return F.gelu(v, approximate="tanh")


def mlp(params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """Gated MLP: SwiGLU (silu) or GeGLU (gelu)."""
    act = F.silu if ctx.cfg.ffn_activation == "silu" else _gelu_tanh
    h = act(dense(x, params["w1"], ctx, "mlp")) * dense(x, params["w3"], ctx, "mlp")
    return dense(h, params["w2"], ctx, "mlp")

