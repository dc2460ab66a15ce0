"""Mixture-of-Experts feed-forward: top-k routing, capacity, sort-based dispatch.

Counterpart of ``repro/models/moe.py``: its global path (``moe_ffn``
after the sharded branch) and ``_moe_sharded``.  The (T, k) expert assignments are flattened
and sorted by expert id, stably; each assignment's rank within its
expert's run is its slot, and slots at or past the capacity are dropped
(scattered to a dummy row that is cut off).  The tokens go into an (E, C,
d) buffer, the gated expert FFN runs on it, and the rows come back to
their tokens weighted by the normalised router gates.

What the port does on purpose:

- **The router is exact and float32**, its weight too, in a bf16 model
  (the paper keeps the multiplier's controller exact).
- **top-k** is a stable descending sort: on equal probabilities the lower
  expert id comes first, as ``jax.lax.top_k`` orders them (``torch.topk``
  promises no order among ties).
- **capacity** is ``int(max(1, round(tokens * k / e * cf)))`` with
  Python's round (half to even), capped at the token count.
- **The combine sums in a fixed order**: each token adds its kept rows in
  the order of their slots in the sorted assignments (ascending expert id)
  into a float32 zero, the order in which the reference's scatter-add
  visits them.  No atomics, so two runs on the same inputs give the same
  bits (``index_add_`` on CUDA would not).
- **Expert GEMMs** (:func:`expert_gemm`): a batched product in the
  working dtype when ``moe`` is not approximated.  When it is, one engine
  ``matmul`` per expert with ``approx.for_target("moe")``, in expert
  order, with the straight-through gradient; stochastic modes draw each
  expert's noise from one generator in that order.  The reference pins
  these calls to its reference backend because Pallas bodies do not batch
  under its ``vmap``; the port keeps the config's backend, so on the card
  they run the hand-written GEMM kernels (``lut_matmul``,
  ``packed_matmul``, ...), E launches per projection.

Under a live mesh (``distributed.sharding``) the path is the reference's:

- **(data, model) mesh with a model axis larger than 1**, E divisible by
  it and at least k tokens a data rank (``moe_ffn``'s condition):
  :func:`_moe_sharded`.  Each data rank routes its own tokens with a
  local capacity ``cap_loc``; each model rank owns E / model experts and
  runs one engine ``matmul`` per local expert on its (cap_loc, d) slot
  block, with the absmax and the ``inject`` draws global over the data
  ranks (the reference's expert GEMM sees the (E, data x cap_loc, d)
  buffer); the aux loss averages ``me`` and ``ce`` over the data ranks
  (``sharding.data_mean``); the combine adds each token's rows in the
  fixed slot order on every rank and then sums the model ranks' partial
  outputs (``sharding.reduce_from``, or within ``sharding.seq_parallel``
  a reduce-scatter over the sequence).  Placed expert weights are this
  rank's blocks (``we1``/``we3`` ``(TP, FSDP, None)``, ``we2`` ``(TP,
  None, FSDP)``), gathered over ``data`` by ``sharding.use``; whole ones
  are sliced to the rank's experts.  The path is differentiable: the
  dispatch ``index_put`` and the gather by ``r.token`` carry gradients
  to the tokens (through ``sharding.copy_to``: each model rank adds its
  experts' part), and the gates carry them to the router (the gate
  probabilities through ``copy_to``, the aux loss's from every rank
  whole).  Rows that arrive replicated (the single-row admission
  prefill) are cut to each data rank's share and gathered again after,
  as the reference's ``shard_map`` splits them.
- **otherwise, rows split over data ranks**: the tokens are gathered and
  routed globally, capacity counted over every token of the batch, and
  each rank keeps its own rows of the output, so the result does not
  depend on the rank count.

Every collective is one of ``distributed.sharding``'s, counted by kind.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.engine import dispatch as _engine, modes as _engine_modes
from repro_torch.models import layers
from repro_torch.models.layers import Ctx

__all__ = ["Routing", "capacity", "expert_gemm", "init_moe", "moe_ffn", "route"]


def init_moe(cfg: ModelConfig, dtype, device, generator) -> dict:
    """Seeded expert weights with the reference's scales; the router is
    drawn in the working dtype and kept float32, as ``init_moe`` does."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    nrm = lambda shape, s: layers.normal_init(shape, s, dtype, device, generator)
    return {
        "router": nrm((d, e), d**-0.5).to(torch.float32),
        "we1": nrm((e, d, f), d**-0.5),
        "we3": nrm((e, d, f), d**-0.5),
        "we2": nrm((e, f, d), f**-0.5),
    }


def capacity(tokens: int, k: int, e: int, capacity_factor: float) -> int:
    """Slots per expert: ``round(tokens * k / e * cf)`` (half to even), at
    least 1 and at most ``tokens``."""
    return min(int(max(1, round(tokens * k / e * capacity_factor))), tokens)


class Routing(NamedTuple):
    """One batch's routing; assignments are flattened token-major (T * k)."""

    expert: torch.Tensor  # (T, k) expert ids, largest probability first
    gate: torch.Tensor  # (T, k) float32 gates, normalised over the k
    order: torch.Tensor  # (T*k,) the stable sort of the assignments by expert
    dest: torch.Tensor  # (T*k,) sorted assignment -> buffer row; E*cap if dropped
    keep: torch.Tensor  # (T*k,) sorted assignment within its expert's capacity
    token: torch.Tensor  # (T*k,) sorted assignment -> its token
    cap: int
    aux: torch.Tensor  # the Switch-style load-balance loss, float32 0-d


def route(router: torch.Tensor, x2: torch.Tensor, cfg: ModelConfig, *,
          mean_over=None, gates_over=None) -> Routing:
    """Router logits in float32, softmax, top-k, the aux loss and the
    sort-based dispatch with capacity (``moe_ffn``'s first half).
    ``mean_over`` averages the aux loss's two statistics over the ranks
    that route their own tokens, and ``gates_over`` is the model axis
    whose ranks each combine a part of the gated rows (``_moe_sharded``:
    the gates' gradient is added over it, the aux loss's is every rank's
    whole)."""
    tokens = x2.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = x2.to(torch.float32) @ router.to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    expert = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[:, :k]
    gate = torch.gather(sharding.copy_to(probs, gates_over), -1, expert)
    gate = gate / torch.clamp_min(gate.sum(dim=-1, keepdim=True), 1e-9)

    flat_e = expert.reshape(-1)
    me = probs.mean(dim=0)
    # each expert's count with a length fixed by e (bincount's depends on
    # the data, so it cannot run on the meta tensors the dry-run counts
    # on); a 0-d divisor on the device: CUDA divides by a host scalar as a
    # multiply by its reciprocal
    counts = torch.zeros((e,), dtype=torch.int64, device=x2.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    ce = counts.to(torch.float32) / torch.full((), float(tokens * k), device=x2.device)
    if mean_over is not None:
        me, ce = mean_over(me), mean_over(ce)
    aux = e * torch.sum(me * ce)

    cap = capacity(tokens, k, e, cfg.capacity_factor)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # rank within the expert's contiguous run of the sorted assignments
    pos = torch.arange(tokens * k, device=x2.device) - torch.searchsorted(
        sorted_e, sorted_e, side="left")
    keep = pos < cap
    dest = torch.where(keep, sorted_e * cap + pos, e * cap)
    return Routing(expert, gate, order, dest, keep, order // k, cap, aux)


def expert_gemm(x: torch.Tensor, w: torch.Tensor, ctx: Ctx, *,
                experts: tuple = (0, None)) -> torch.Tensor:
    """(E, C, a) @ (E, a, b) -> (E, C, b), through the multiplier when
    ``moe`` is targeted (see the module's note).  ``experts = (first,
    total)``: x and w hold experts ``first ..`` of ``total``; a stochastic
    mode's generator skips the other experts' draws, so each expert draws
    what it draws when every expert is local."""
    ap = ctx.cfg.approx
    if not ap.enabled or "moe" not in ap.targets:
        return torch.bmm(x, w.to(x.dtype))
    ap = ap.for_target("moe")
    generator = _engine_modes.default_generator(ap.mode, ctx.generator, x.device)
    first, total = experts
    total = x.shape[0] if total is None else total

    def skip(count):
        if generator is not None and count:
            rows = sharding.global_rows(x.shape[1])[0]
            for _ in range(count):
                torch.randn((rows, w.shape[-1]), generator=generator, device=x.device)

    skip(first)
    outs = [
        _engine.matmul(x[i].to(torch.float32), w[i].to(torch.float32), n=ap.n, t=ap.t,
                       fix_to_1=ap.fix_to_1, mode=ap.mode, rank=ap.rank,
                       generator=generator, backend=ap.backend)
        for i in range(x.shape[0])
    ]
    skip(total - first - x.shape[0])
    return torch.stack(outs).to(x.dtype)


def _combine(y: torch.Tensor, r: Routing, tokens: int) -> torch.Tensor:
    """(E, C, d) expert outputs -> (T, d) float32: each token's kept rows,
    times their gates, added in slot order (ascending expert id)."""
    e_cap, d = y.shape[0] * y.shape[1], y.shape[2]
    y_flat = torch.cat([y.reshape(e_cap, d), y.new_zeros((1, d))])
    w_tok = (r.gate.reshape(-1)[r.order] * r.keep).to(torch.float32)[:, None]
    rows = y_flat[r.dest].to(torch.float32) * w_tok  # (T*k, d), sorted order
    k = r.order.numel() // tokens
    # each token's k sorted positions, ascending: the scatter-add's visiting order
    slot_of = torch.empty_like(r.order)
    slot_of[r.order] = torch.arange(r.order.numel(), device=r.order.device)
    slots = torch.sort(slot_of.view(tokens, k), dim=1).values
    out = rows.new_zeros((tokens, d))
    for j in range(k):
        out = out + rows[slots[:, j]]
    return out


def _act(cfg: ModelConfig):
    return F.silu if cfg.ffn_activation == "silu" else layers._gelu_tanh


def _split_experts(w: torch.Tensor) -> bool:
    """Whether ``w`` is a placed block of experts split over the model axis."""
    spec = getattr(w, "spec", None)
    return bool(spec) and sharding.TP in sharding.spec_axes(spec[0])


def _expert_weight(w: torch.Tensor, e0: int, e_loc: int) -> torch.Tensor:
    """This rank's experts of ``w``: its placed block, gathered over
    ``data``; or whole weights sliced."""
    return sharding.use(w) if _split_experts(w) else sharding.use(w)[e0:e0 + e_loc]


def _local_experts(params, x2: torch.Tensor, r: Routing, ctx: Ctx, model, mesh=None):
    """The experts ``model`` gives this rank (every expert without it) over
    the tokens ``x2`` (T, d) routed by ``r``: this rank's part of the
    combine (T, d) float32, to be summed over ``model``.  With ``mesh``,
    the slot blocks are this data rank's, and the GEMMs see every data
    rank's (the module's note)."""
    t, d = x2.shape
    e = ctx.cfg.num_experts
    e_loc = e if model is None else e // model.size
    e0 = 0 if model is None else model.index * e_loc
    sorted_e = r.expert.reshape(-1)[r.order]
    mine = r.keep & (sorted_e >= e0) & (sorted_e < e0 + e_loc)
    r = r._replace(keep=mine, dest=torch.where(mine, r.dest - e0 * r.cap, e_loc * r.cap))
    xd = sharding.copy_to(x2, model)  # each model rank dispatches to its experts
    xs = torch.where(mine[:, None], xd[r.token], xd.new_zeros(()))
    buf = xd.new_zeros((e_loc * r.cap + 1, d)).index_put((r.dest,), xs)
    buf = buf[: e_loc * r.cap].reshape(e_loc, r.cap, d)

    local = {n: _expert_weight(params[n], e0, e_loc) for n in ("we1", "we3", "we2")}
    kw = {} if model is None else {"experts": (e0, e)}
    with contextlib.nullcontext() if mesh is None else sharding.mesh_context(mesh, rows=True):
        def gemm(v, w):
            return expert_gemm(v, w, ctx, **kw)

        h = _act(ctx.cfg)(gemm(buf, local["we1"])) * gemm(buf, local["we3"])
        y = gemm(h, local["we2"])  # (E_loc, C, d)
    return _combine(y, r, t)


def _moe_sharded(params, x_loc: torch.Tensor, ctx: Ctx, mesh):
    """Expert parallelism on a (data, model) mesh (see the module's note):
    this rank's tokens ``x_loc`` (T_loc, d) -> (this model rank's partial
    output (T_loc, d) float32, to be summed over the model axis, and the
    aux loss)."""
    model = sharding.model_axis(mesh)
    # the local capacity: route counts it over this data rank's tokens
    r = route(sharding.use(params["router"]), x_loc, ctx.cfg,
              mean_over=lambda t: sharding.data_mean(t, mesh), gates_over=model)
    return _local_experts(params, x_loc, r, ctx, model, mesh), r.aux


def _sharded_applies(cfg: ModelConfig, mesh, tokens: int) -> bool:
    """The reference's condition for ``_moe_sharded`` (``tokens`` global)."""
    sizes = sharding.mesh_axis_sizes(mesh)
    msize = sizes.get(sharding.TP, 1)
    dsize = 1
    for a in sharding.DP:
        dsize *= sizes.get(a, 1)
    return (msize > 1 and cfg.num_experts % msize == 0 and tokens % dsize == 0
            and tokens // dsize >= cfg.num_experts_per_tok)


def moe_ffn(params, x: torch.Tensor, ctx: Ctx) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux loss float32 0-d)."""
    cfg = ctx.cfg
    b, s, d = x.shape
    tokens = b * s
    x2 = x.reshape(tokens, d)
    mesh = sharding.ambient_mesh()
    rows = sharding.row_axis()
    rsize = 1 if rows is None else rows.size
    if _sharded_applies(cfg, mesh, tokens * rsize):
        model = sharding.model_axis(mesh)
        data = sharding.mesh_axis(mesh, sharding.FSDP)
        if rows is None and data is not None and data.size > 1:
            # replicated rows (serving's admission prefill): each data rank
            # takes its share, and the shares are gathered again
            share = tokens // data.size
            out, aux = _moe_sharded(params, x2[data.index * share:(data.index + 1) * share],
                                    ctx, mesh)
            out = sharding.gather_rows(sharding.reduce_from(out, model), data)
        else:
            out, aux = _moe_sharded(params, x2, ctx, mesh)
            return sharding.row_output(out.reshape(b, s, d), model).to(x.dtype), aux
    elif rows is not None:  # (c) on a data mesh: route every rank's tokens together
        xg = sharding.gather_rows(x2, rows)
        with sharding.rows_replicated():
            out, aux = _moe_global(params, xg, ctx)
        out = out[rows.index * tokens:(rows.index + 1) * tokens]
    else:
        out, aux = _moe_global(params, x2, ctx)
    return out.reshape(b, s, d).to(x.dtype), aux


def _moe_global(params, x2: torch.Tensor, ctx: Ctx) -> tuple[torch.Tensor, torch.Tensor]:
    """The global path over the tokens x2 (T, d): (out (T, d) float32, aux).
    Placed experts split over the model axis (a batch too small for
    ``_moe_sharded``) each run on their rank, and the parts are summed."""
    model = sharding.model_axis() if _split_experts(params["we1"]) else None
    r = route(sharding.use(params["router"]), x2, ctx.cfg, gates_over=model)
    return sharding.reduce_from(_local_experts(params, x2, r, ctx, model), model), r.aux
