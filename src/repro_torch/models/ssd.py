"""Mamba-2 SSD (state-space duality) mixer, chunked matmul formulation.

Counterpart of ``repro/models/ssd.py``.  The selective state-space
recurrence (per head)::

    S_t = exp(dt_t * A) * S_{t-1} + dt_t * B_t x_t^T
    y_t = C_t . S_t + D * x_t

is evaluated in the SSD chunked form (Dao & Gu, 2024): within a chunk of L
steps the output is an attention-like product against a decay-masked Gram
matrix; across chunks a linear recurrence over the chunk states runs as a
log-depth scan (``rglru.linear_scan``).  Decode carries (conv state, SSM
state (B, H, P, N) float32) and costs O(1) per token.  The in/out
projections run through the approximate multiplier (the ``mlp`` target);
the state update stays exact.

As in the reference, a prefill given a cache treats it as fresh: the
chunked scan starts from a zero SSM state (the conv reads the cache's
inputs).  A given cache is updated in place and returned.

**Tensor parallelism** (placed parameters, ``distributed.sharding``).  The
reference's column rule splits ``in_proj``'s output contiguously, and that
output concatenates z | x | B | C | dt, so its blocks do not line up with
heads (at ``.reduced()`` a rank of two holds z and 20 channels of x);
``conv_w`` is split the same way over x | B | C.  So the block makes both
whole: the projection's output and ``conv_w`` are all-gathered over the
model axis (their gradients reduce-scattered back), or, where the rule
leaves ``in_proj`` replicated (3,352 columns on 16 ranks), the whole
product is kept with its gradient added over the model group.  The
chunked scan then runs on this rank's heads, as the reference constrains
``xh`` to ``(DP, None, TP, None)``, where the model axis divides the
heads; else on every head.  ``out_proj`` is row-parallel: this rank's
columns of y go through its rows and the partials are summed
(``y``'s ``(DP, None, TP)``).  Where ``out_proj`` too is replicated, every
rank computes the block whole.  The small float32 leaves and ``conv_b``
are replicated; a rank reads its heads' entries, and their gradients are
added over the model group.  Caches follow ``launch/specs.py``: the state
(B, H, P, N) split over heads, the conv tail (B, K-1, C) over channels,
each where the axis divides; the conv reads the whole tail (gathered) and
each rank keeps its channels of the new one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import layers
from repro_torch.models.layers import Ctx
from repro_torch.models.rglru import _causal_conv, linear_scan, softplus

__all__ = ["SSDCache", "init_ssd", "init_ssd_cache", "ssd_block"]


class SSDCache(NamedTuple):
    conv: torch.Tensor  # (B, conv_width - 1, d_inner + 2N), model dtype
    state: torch.Tensor  # (B, H, P, N) float32


def _dims(cfg: ModelConfig):
    d_inner = cfg.d_inner or 2 * cfg.d_model
    heads = cfg.ssm_heads or d_inner // cfg.ssm_head_dim
    return d_inner, heads, cfg.ssm_head_dim, cfg.ssm_state


def init_ssd(cfg: ModelConfig, dtype, device, generator) -> dict:
    """Seeded tensors with the reference's scales; ``ssm_a``, ``ssm_d`` and
    ``dt_bias`` float32 in any model."""
    d = cfg.d_model
    d_inner, h, p, n = _dims(cfg)
    conv_ch = d_inner + 2 * n  # x, B, C all pass the causal conv
    in_dim = 2 * d_inner + 2 * n + h  # z, x, B, C, dt
    f32 = torch.float32
    return {
        "in_proj": layers.normal_init((d, in_dim), d**-0.5, dtype, device, generator),
        "conv_w": layers.normal_init((cfg.conv_width, conv_ch), 0.1, dtype, device, generator),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "ssm_a": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=device)),  # A = -exp(.)
        "ssm_d": torch.ones((h,), dtype=f32, device=device),
        "dt_bias": torch.log(torch.expm1(torch.full((h,), 0.01, dtype=f32, device=device))),
        "out_proj": layers.normal_init((d_inner, d), d_inner**-0.5, dtype, device, generator),
    }


def init_ssd_cache(cfg: ModelConfig, batch: int, dtype, device, ax=None) -> SSDCache:
    """A zero cache; with a model axis ``ax``, this rank's shard of it (the
    module's note)."""
    d_inner, h, p, n = _dims(cfg)
    return SSDCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, sharding.local_size(d_inner + 2 * n, ax)),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, sharding.local_size(h, ax), p, n), dtype=torch.float32,
                          device=device),
    )


class _Plan(NamedTuple):
    """How one rank runs a block under a model axis (the module's note)."""

    ax: Optional[sharding.Axis]  # the model axis where out_proj's rows split over it
    heads: tuple  # the heads this rank computes, [lo, hi)
    cols: tuple  # its columns of y (of the computed heads') that out_proj's rows take


def _plan(params, cfg: ModelConfig) -> Optional[_Plan]:
    """None without a placed model axis."""
    ax = sharding.model_axis() if hasattr(params["out_proj"], "spec") else None
    if ax is None:
        return None
    d_inner, h, p, _ = _dims(cfg)
    if sharding.tp_role(params["out_proj"].spec) != "row":
        return _Plan(None, (0, h), (0, d_inner))
    c = d_inner // ax.size
    if sharding.splits(h, ax):  # the state's heads: this rank's, aligned with its rows
        lo = ax.index * h // ax.size
        return _Plan(ax, (lo, lo + h // ax.size), (0, c))
    return _Plan(ax, (0, h), (ax.index * c, (ax.index + 1) * c))


def _whole(t: torch.Tensor, w: torch.Tensor, plan: _Plan, dim: int) -> torch.Tensor:
    """``t`` (a product of ``w``, or ``w`` itself) whole on every rank:
    all-gathered along ``dim`` where ``w``'s spec splits it over the model
    axis, and with its gradient added over the model group where the rank
    uses a part of it (``plan.ax``)."""
    ax = sharding.model_axis()
    if sharding.TP in sharding.spec_axes(w.spec[dim]):
        return sharding.all_gather(t, ax, dim) if plan.ax else sharding.all_gather_keep(
            t, ax, dim)
    return sharding.copy_to(t, plan.ax)


def _segsum(z: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L) lower-triangular sums: out[i, j] = sum_{j<k<=i} z_k
    (-inf above the diagonal)."""
    l = z.shape[-1]
    cs = torch.cumsum(z, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=z.device))
    return out.masked_fill(~mask, -torch.inf)


def _ssd_chunked(xh, dt, a, b_in, c_in, chunk: int):
    """xh: (B, S, H, P); dt: (B, S, H) (after softplus); a: (H,) (negative);
    b_in, c_in: (B, S, N), all float32.  Returns (y (B, S, H, P), the final
    state (B, H, P, N))."""
    bsz, s, h, p = xh.shape
    n = b_in.shape[-1]
    l = min(chunk, s)
    pad = (-s) % l
    if pad:
        # zero-pad the tail: dt = 0 makes a padded step the identity on the
        # state (decay exp(0) = 1, nothing injected), so the final state is exact
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    s_pad = s + pad
    nc = s_pad // l

    xc = xh.reshape(bsz, nc, l, h, p)
    dtc = dt.reshape(bsz, nc, l, h)
    bc = b_in.reshape(bsz, nc, l, n)
    cc = c_in.reshape(bsz, nc, l, n)

    da = dtc * a[None, None, None, :]  # (B, C, L, H) log-decay increments
    da_cum = torch.cumsum(da, dim=2)  # within-chunk cumulative
    da_total = da_cum[:, :, -1, :]  # (B, C, H)

    # within a chunk: Y[i] = sum_{j<=i} C_i.B_j exp(seg) dt_j x_j
    seg = _segsum(da.movedim(2, 3))  # (B, C, H, L, L)
    gram = torch.einsum("bcin,bcjn->bcij", cc, bc)  # (B, C, L, L)
    m = gram[:, :, None, :, :] * torch.exp(seg)  # (B, C, H, L, L)
    y_intra = torch.einsum("bchij,bcjh,bcjhp->bcihp", m, dtc, xc)

    # chunk states: S_c = sum_j exp(da_total - da_cum_j) dt_j B_j x_j^T
    decay_state = torch.exp(da_total[:, :, None, :] - da_cum)  # (B, C, L, H)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", bc, decay_state * dtc, xc)

    # across chunks: the linear recurrence over C, a log-depth scan
    s_all = linear_scan(torch.exp(da_total), states, dim=1)
    # the state entering chunk c is s_all[c - 1]
    s_prev = torch.cat([torch.zeros_like(s_all[:, :1]), s_all[:, :-1]], dim=1)

    # the states' part of the output: y_off[i] = C_i . (exp(da_cum_i) S_prev)
    decay_out = torch.exp(da_cum)  # (B, C, L, H)
    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp", cc, s_prev, decay_out)

    y = (y_intra + y_inter).reshape(bsz, s_pad, h, p)[:, :s]
    return y, s_all[:, -1]


def ssd_block(params, x: torch.Tensor, ctx: Ctx, cache: Optional[SSDCache] = None) -> tuple:
    """x: (B, S, d_model) -> (out, cache): the cache updated in place, or None."""
    cfg = ctx.cfg
    d_inner, h, p, n = _dims(cfg)
    bsz, s, _ = x.shape
    f32 = torch.float32
    plan = _plan(params, cfg)

    zxbcdt = layers.dense(x, params["in_proj"], ctx, "mlp")
    conv_w, conv_b, dt_bias, ssm_a, ssm_d = (
        sharding.use(params[k]) for k in ("conv_w", "conv_b", "dt_bias", "ssm_a", "ssm_d"))
    conv_cache = cache.conv if cache is not None else None
    if plan is not None:
        zxbcdt = _whole(zxbcdt, params["in_proj"], plan, -1)
        split_conv = sharding.TP in sharding.spec_axes(params["conv_w"].spec[1])
        conv_w = _whole(conv_w, params["conv_w"], plan, 1)
        conv_b, dt_bias, ssm_a, ssm_d = (sharding.copy_to(v, plan.ax)
                                         for v in (conv_b, dt_bias, ssm_a, ssm_d))
        if conv_cache is not None and split_conv:
            conv_cache = sharding.gather(conv_cache, sharding.model_axis(), 2)
    z, xr, b_in, c_in, dt = torch.split(zxbcdt, [d_inner, d_inner, n, n, h], dim=-1)
    conv_in = torch.cat([xr, b_in, c_in], dim=-1)

    conv_out, new_conv = _causal_conv(conv_in, conv_w, conv_b, conv_cache)
    conv_out = F.silu(conv_out)
    xr, b_in, c_in = torch.split(conv_out, [d_inner, n, n], dim=-1)

    lo, hi = (0, h) if plan is None else plan.heads
    dt = softplus(dt[..., lo:hi].to(f32) + dt_bias[lo:hi])  # (B, S, H)
    a = -torch.exp(ssm_a[lo:hi])  # (H,)
    xh = xr[..., lo * p:hi * p].to(f32).reshape(bsz, s, hi - lo, p)

    if cache is not None and s == 1:
        # O(1) decode: S = exp(dt a) S + dt B x^T ; y = C.S
        da = torch.exp(dt[:, 0, :] * a[None, :])  # (B, H)
        dbx = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], b_in[:, 0].to(f32), xh[:, 0])
        state = da[..., None, None] * cache.state + dbx
        y = torch.einsum("bn,bhpn->bhp", c_in[:, 0].to(f32), state)[:, None]
    else:
        # prefill: a given cache is taken as fresh (zero state), as the reference does
        y, state = _ssd_chunked(xh, dt, a, b_in.to(f32), c_in.to(f32), cfg.ssm_chunk)

    y = y + ssm_d[lo:hi][None, None, :, None] * xh
    y = y.reshape(bsz, s, (hi - lo) * p).to(x.dtype)
    y = y * F.silu(z[..., lo * p:hi * p])
    if plan is not None and plan.ax is not None:
        y = y[..., plan.cols[0]:plan.cols[1]]
    out = layers.dense(y, params["out_proj"], ctx, "mlp")
    if cache is not None:
        if plan is not None and split_conv:
            new_conv = sharding.split(new_conv, sharding.model_axis(), 2)
        cache.conv.copy_(new_conv)
        cache.state.copy_(state)
    return out, cache
