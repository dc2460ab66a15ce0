"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Counterpart of ``repro/models/rglru.py``.  Block::

    x -> [in_x proj -> causal conv1d -> RG-LRU]  *  gelu(in_gate proj) -> out proj

RG-LRU recurrence (De et al., 2024)::

    r_t = sigmoid(x_t W_r + b_r)              recurrence gate
    i_t = sigmoid(x_t W_i + b_i)              input gate
    a_t = exp(-c * softplus(Lambda) * r_t)    per-channel decay, c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The in/gate/out projections run through the approximate multiplier (the
``mlp`` target); the gates' float32 products and the recurrence stay
exact: the recurrence is the accumulator, which the paper never
approximates.  Prefill evaluates the recurrence as a log-depth scan of
torch ops (:func:`linear_scan`, ``ceil(log2 S)`` steps, where the
reference runs ``jax.lax.associative_scan``); decode is the single-step
update on the carried state.

A given cache is updated in place (its tensors keep their storage), as the
KV cache is, and returned.

**Tensor parallelism** (placed parameters, ``distributed.sharding``).  The
reference constrains ``xb`` to ``(DP, None, TP)``: the recurrence is
split over W.  ``in_x`` and ``in_gate`` match no tensor-parallel rule and
take the default FSDP placement, as does ``lru_in_w``; ``lru_in_b``,
``lru_gate_w`` and ``lru_gate_b`` are replicated; ``conv_w`` is ``(None,
TP)`` and ``out_proj`` ``(TP, FSDP)``.  So each rank computes the two
input products whole, gathers ``conv_w`` and runs the conv over every
channel (the gate products need the whole ``xb``), takes its W columns of
the gate products, runs the scan on them (elementwise in W) and feeds
its rows of ``out_proj``, whose partials are summed.  The gradients of
what every rank computes whole are added over the model group.  The
carried state ``h`` (B, W) is split over W and the conv tail (B, K-1, W)
over channels, as ``launch/specs.py`` places them.  Where the model axis
does not divide W, every rank computes the block whole.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import layers
from repro_torch.models.layers import Ctx

__all__ = ["RGLRUCache", "init_rglru", "init_rglru_cache", "linear_scan", "rglru_block",
           "softplus"]

_C = 8.0


class RGLRUCache(NamedTuple):
    conv: torch.Tensor  # (B, conv_width - 1, W) trailing inputs, model dtype
    h: torch.Tensor  # (B, W) recurrent state, float32


def init_rglru(cfg: ModelConfig, dtype, device, generator) -> dict:
    """Seeded tensors with the reference's scales; ``lru_a`` float32 in any model."""
    w, d = cfg.lru_width, cfg.d_model
    lam = torch.log(torch.expm1(torch.linspace(0.9, 0.999, w, dtype=torch.float32,
                                               device=device)))
    zeros = lambda: torch.zeros((w,), dtype=dtype, device=device)
    return {
        "in_x": layers.normal_init((d, w), d**-0.5, dtype, device, generator),
        "in_gate": layers.normal_init((d, w), d**-0.5, dtype, device, generator),
        "conv_w": layers.normal_init((cfg.conv_width, w), 0.1, dtype, device, generator),
        "conv_b": zeros(),
        "lru_a": lam,  # Lambda (softplus -> decay rate)
        "lru_gate_w": layers.normal_init((w, w), w**-0.5, dtype, device, generator),
        "lru_gate_b": zeros(),
        "lru_in_w": layers.normal_init((w, w), w**-0.5, dtype, device, generator),
        "lru_in_b": zeros(),
        "out_proj": layers.normal_init((w, d), w**-0.5, dtype, device, generator),
    }


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device, ax=None) -> RGLRUCache:
    """A zero cache; with a model axis ``ax``, this rank's shard of it (the
    module's note)."""
    w = sharding.local_size(cfg.lru_width, ax)
    return RGLRUCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device),
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
    )


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x (``F.softplus``
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 cache: Optional[torch.Tensor]) -> tuple:
    """Depthwise causal conv1d.  x: (B, S, W); w: (K, W).  Summed in x's
    dtype in the reference's order, ``0 + t_0 + ... + t_{K-1}``; returns
    (out, the last K - 1 inputs, or None without a cache)."""
    k = w.shape[0]
    if cache is not None:
        ctx_in = torch.cat([cache.to(x.dtype), x], dim=1)  # (B, K-1+S, W)
        new_cache = ctx_in[:, -(k - 1):, :] if k > 1 else cache
    else:
        ctx_in = F.pad(x, (0, 0, k - 1, 0))
        new_cache = None
    s = x.shape[1]
    out = sum(ctx_in[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :], new_cache


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = 0`` along ``dim``, in
    ``ceil(log2 S)`` steps of whole-tensor ops (Hillis-Steele), each
    combining ``(a_l, b_l)`` before ``(a_r, b_r)`` as the reference's
    ``comb`` does: ``(a_l * a_r, b_l * a_r + b_r)``.  ``b`` may have more
    trailing dims than ``a``, over which ``a`` broadcasts."""
    extra = (1,) * (b.ndim - a.ndim)
    s, d = a.shape[dim], 1
    while d < s:
        a_l, a_r = a.narrow(dim, 0, s - d), a.narrow(dim, d, s - d)
        b_l, b_r = b.narrow(dim, 0, s - d), b.narrow(dim, d, s - d)
        b = torch.cat([b.narrow(dim, 0, d), b_l * a_r.reshape(a_r.shape + extra) + b_r], dim)
        a = torch.cat([a.narrow(dim, 0, d), a_l * a_r], dim)
        d *= 2
    return b


def _rglru_scan(xb: torch.Tensor, a_t: torch.Tensor, i_t: torch.Tensor,
                h0: torch.Tensor) -> tuple:
    """xb, a_t, i_t: (B, S, W) float32; h0 (B, W).  Returns (h over S, final h)."""
    b_t = torch.sqrt(torch.clamp(1.0 - a_t * a_t, min=0.0)) * (i_t * xb)
    # fold the initial state into the first element
    b_t = torch.cat([b_t[:, :1] + (a_t[:, 0] * h0)[:, None], b_t[:, 1:]], dim=1)
    h_all = linear_scan(a_t, b_t, dim=1)
    return h_all, h_all[:, -1, :]


def rglru_block(params, x: torch.Tensor, ctx: Ctx,
                cache: Optional[RGLRUCache] = None) -> tuple:
    """x: (B, S, d_model) -> (out, cache): the cache updated in place, or None."""
    xb = layers.dense(x, params["in_x"], ctx, "mlp")  # (B, S, W)
    gb = layers.dense(x, params["in_gate"], ctx, "mlp")
    width = xb.shape[-1]
    ax = (sharding.model_axis()
          if sharding.tp_role(getattr(params["out_proj"], "spec", None)) == "row" else None)
    p = {k: sharding.use(params[k]) for k in ("conv_w", "conv_b", "lru_a", "lru_gate_w",
                                              "lru_gate_b", "lru_in_w", "lru_in_b")}
    conv_cache = cache.conv if cache is not None else None
    lo, hi = 0, width
    if ax is not None:  # this rank's W columns (the module's note)
        lo, hi = ax.index * width // ax.size, (ax.index + 1) * width // ax.size
        xb, gb = sharding.copy_to(xb, ax), sharding.copy_to(gb, ax)
        p = {k: sharding.all_gather(v, ax, 1) if k == "conv_w" else sharding.copy_to(v, ax)
             for k, v in p.items()}
        if conv_cache is not None:
            conv_cache = sharding.gather(conv_cache, ax, 2)

    xb, new_conv = _causal_conv(xb, p["conv_w"], p["conv_b"], conv_cache)

    f32 = torch.float32
    xb32 = xb.to(f32)
    r = torch.sigmoid(xb32 @ p["lru_gate_w"][:, lo:hi].to(f32)
                      + p["lru_gate_b"][lo:hi].to(f32))
    i = torch.sigmoid(xb32 @ p["lru_in_w"][:, lo:hi].to(f32) + p["lru_in_b"][lo:hi].to(f32))
    log_a = -_C * softplus(p["lru_a"][lo:hi]) * r  # (B, S, W)
    a_t = torch.exp(log_a)
    xb32 = xb32[..., lo:hi]

    if cache is not None and x.shape[1] == 1:
        # the single-step update
        a1, i1, x1 = a_t[:, 0], i[:, 0], xb32[:, 0]
        h = a1 * cache.h + torch.sqrt(torch.clamp(1.0 - a1 * a1, min=0.0)) * (i1 * x1)
        h_seq = h[:, None, :]
    else:
        h0 = cache.h if cache is not None else torch.zeros(
            (x.shape[0], hi - lo), dtype=f32, device=x.device)
        h_seq, h = _rglru_scan(xb32, a_t, i, h0)

    out = h_seq.to(x.dtype) * F.gelu(gb[..., lo:hi], approximate="tanh")
    out = layers.dense(out, params["out_proj"], ctx, "mlp")
    if cache is not None:
        cache.conv.copy_(sharding.split(new_conv, ax, 2))
        cache.h.copy_(h)
    return out, cache
