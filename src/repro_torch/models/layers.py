"""Shared layers: RMSNorm, RoPE and M-RoPE, dense (with the paper's multiplier), gated MLP.

Counterpart of ``repro/models/layers.py``.  Layers are plain functions
over parameter tensors; ``Ctx`` threads the config and the noise
generator through the stack without global state.

Tensor parallelism: a placed weight (``distributed.sharding.place_params``)
carries its spec, and :func:`dense` reads its role from it
(``sharding.tp_role``): a column-parallel weight (``wq``/``wk``/``wv``,
``w1``/``w3``: the model axis on its output dimension) takes its input
through ``sharding.copy_to`` and gives this rank's columns; a
row-parallel one (``wo``, ``w2``) takes this rank's K slice and its
partials are summed over the model group (the engine's integer sums for
the integer modes, ``engine/modes.py``).  So :func:`mlp` is Megatron's
pair: ``h`` stays split over d_ff between ``w1``/``w3`` and ``w2``, as the
reference's ``constrain(h, DP, None, TP)`` places it.  Where a rule
degrades (a dimension the model axis does not divide), the weight is
whole and the layer replicated, as ``_resolve_entry`` degrades.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ApproxConfig, ModelConfig
from repro_torch.distributed import sharding
from repro_torch.engine import dispatch as _engine, modes as _engine_modes

__all__ = ["Ctx", "fold_seed", "rms_norm", "rope", "mrope", "dense", "mlp", "normal_init",
           "init_mlp"]


@dataclasses.dataclass
class Ctx:
    """Call context: the config and an optional generator for the
    stochastic modes.  The reference folds a call-site counter into its
    PRNG key; a generator advances by itself, so each dense call draws
    fresh noise from it.

    Training passes a ``seed`` (made from the run's seed and the step)
    instead: each block then draws from a generator of its own, seeded
    from (seed, layer) and made anew each time the block runs, so a block
    recomputed under remat draws the noise its first pass drew.
    ``torch.utils.checkpoint`` restores only the default generators, not
    an explicit one."""

    cfg: ModelConfig
    generator: Optional[torch.Generator] = None
    seed: Optional[int] = None

    def for_block(self, index: int, device: torch.device) -> "Ctx":
        if self.seed is None:
            return self
        gen = torch.Generator(device=device).manual_seed(fold_seed(self.seed, index))
        return Ctx(cfg=self.cfg, generator=gen)


def fold_seed(seed: int, value: int) -> int:
    """A new 63-bit seed from ``seed`` and ``value`` (splitmix64's finaliser)."""
    z = (seed * 0x9E3779B97F4A7C15 + value + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) >> 1


# --------------------------------------------------------------------- init
def normal_init(shape, scale: float, dtype: torch.dtype, device: torch.device,
                generator: torch.Generator) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in f32 and cast, as ``layers._normal``; on
    the ``meta`` device only the shape and dtype (nothing is drawn)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    z = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return (z * scale).to(dtype)


def init_mlp(cfg: ModelConfig, dtype, device, generator) -> dict:
    """The gated MLP's w1, w3 (d_model, d_ff) and w2 (d_ff, d_model), drawn
    in that order at std fan_in^-1/2 (the reference's ``layers.init_mlp`` scales)."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": normal_init((d, f), d**-0.5, dtype, device, generator),
        "w3": normal_init((d, f), d**-0.5, dtype, device, generator),
        "w2": normal_init((f, d), f**-0.5, dtype, device, generator),
    }


# ------------------------------------------------------------------- layers
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the reference's ``(1 + scale)`` gain (zero-init scales)."""
    scale = sharding.use(scale)
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
    return _rotate(x, positions.to(torch.float32)[..., None] * freqs)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotates the two halves of x (B, S, H, D) by the angles (B, S, D/2), in f32."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope(x: torch.Tensor, positions: torch.Tensor, theta: float, sections: tuple) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, D); positions: (3, B, S), the
    t/h/w ids.  The D/2 frequency bands are cut into ``sections`` in order,
    and each section rotates with its own stream of positions (in float32,
    as ``rope``).  With t = h = w it is ``rope`` bit for bit: every angle
    is the same product."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to head_dim/2 = {half}")
    if positions.shape[0] != len(sections):
        raise ValueError(f"mrope takes {len(sections)} position streams, got "
                         f"{positions.shape[0]}")
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    pos = positions.to(torch.float32)  # (3, B, S)
    bands, lo = [], 0
    for stream, width in enumerate(sections):
        bands.append(pos[stream][..., None] * freqs[lo:lo + width])
        lo += width
    return _rotate(x, torch.cat(bands, dim=-1))


# -------------------------------------------------------- approximate dense
def _approx_2d(x2: torch.Tensor, w: torch.Tensor, ap: ApproxConfig, generator,
               shard=None) -> torch.Tensor:
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
        shard=shard,
    )


def dense(x: torch.Tensor, w: torch.Tensor, ctx: Ctx, kind: str = "mlp") -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out), through the approximate multiplier
    when ``kind`` is targeted.  The engine works in f32; the result is
    cast back to the working dtype, as ``layers.dense`` does.  A placed
    ``w`` runs as its tensor-parallel role (the module's note)."""
    role = sharding.tp_role(getattr(w, "spec", None))
    shard = sharding.Shard(role, sharding.model_axis()) if role else None
    w = sharding.use(w)
    if role == "column":
        x = sharding.copy_to(x, shard.axis)
    ap = ctx.cfg.approx
    if not ap.enabled or kind not in ap.targets:
        out = x @ w.to(x.dtype)
        return sharding.row_output(out, shard.axis) if role == "row" else out
    ap = ap.for_target(kind)
    lead = x.shape[:-1]
    args = (x.reshape(-1, x.shape[-1]), w, ap, ctx.generator) + ((shard,) if shard else ())
    out = _approx_2d(*args)
    return out.reshape(*lead, w.shape[-1]).to(x.dtype)


def _gelu_tanh(v: torch.Tensor) -> torch.Tensor:
    return F.gelu(v, approximate="tanh")


def mlp(params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """Gated MLP: SwiGLU (silu) or GeGLU (gelu)."""
    act = F.silu if ctx.cfg.ffn_activation == "silu" else _gelu_tanh
    h = act(dense(x, params["w1"], ctx, "mlp")) * dense(x, params["w3"], ctx, "mlp")
    return dense(h, params["w2"], ctx, "mlp")

