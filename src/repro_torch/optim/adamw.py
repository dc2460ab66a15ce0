"""AdamW with optional 8-bit block-quantized moments, cosine schedule,
global-norm clipping.

Counterpart of ``repro/optim/adamw.py``, in PyTorch's own idiom: the
parameters are updated in place, and the state holds one moment pair per
*leaf of the reference's parameter tree*
(``models.registry.reference_leaves``), each flattened.  A leaf that the
reference stacks over the layers of a scanned group (``scan_layers=True``,
as its train driver sets) is the concatenation of the port's per-layer
tensors, in layer order, so that:

- the 8-bit path quantizes the same 256-value blocks as the reference
  (a block may span two layers of a stacked leaf);
- weight decay follows the reference's rule ``p.ndim >= 2`` on *its*
  layout: every tensor of a block in a scanned group is decayed, the
  per-layer norm vectors and qk-norm scales included, since they are
  stacked to (L, D); ``final_norm`` (D,) is not.  That is the reference's
  behaviour and the port keeps it (ROADMAP.md §3);
- the reference's optimizer state loads leaf by leaf (:func:`from_reference`).

The arithmetic is the reference's, operation for operation, in float32.
Divisions whose divisor is a scalar run against a 0-d tensor on the
parameters' device: CUDA divides by a host scalar as a multiply by its
reciprocal, which can move the last bit and with it an 8-bit code.  The
schedule is computed on the host in float32 and moved to the device.

**On local shards** (:func:`update` with a ``mesh``, the sharded train step): the
parameters are each rank's blocks (``distributed.sharding.place_params``)
and a float32 moment is the block of its leaf under the leaf's spec
(``checkpoint.manager.shard_train_state``), so the update is the same
elementwise arithmetic on this rank's elements.  The global norm counts
each element once: a leaf replicated over a mesh axis adds its squares on
that axis's first rank only, then the sum is all-reduced over every axis
(:func:`global_norm_sharded`).  8-bit moments stay whole on every rank, as
``shard_train_state`` keeps them, so their 256-value blocks fall where the
unsharded leaf's fall: their leaf's update runs on its whole gradient and
parameter, gathered, and each rank keeps its block of the new parameter.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from repro_torch.configs.base import TrainConfig

__all__ = [
    "BLOCK", "OptState", "Q8", "dq8", "flatten_leaves", "from_reference", "global_norm",
    "global_norm_sharded", "init", "q8", "schedule", "update",
]

BLOCK = 256


class Q8(NamedTuple):
    code: torch.Tensor  # int8 (nblocks, BLOCK)
    scale: torch.Tensor  # f32 (nblocks,)


class OptState(NamedTuple):
    step: torch.Tensor  # int64 0-d, on the host
    mu: list  # per reference leaf: flat f32, or Q8
    nu: list


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(value), dtype=torch.float32, device=like.device)


def q8(x: torch.Tensor) -> Q8:
    """Block absmax int8 codes of ``x`` flattened, zero-padded to a whole block."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / _const(127.0, flat)
    code = torch.round(blocks / torch.clamp_min(scale, 1e-12)[:, None]).to(torch.int8)
    return Q8(code, scale)


def dq8(q: Q8, numel: int) -> torch.Tensor:
    """The flat f32 values of ``q``'s first ``numel`` entries."""
    return (q.code.to(torch.float32) * q.scale[:, None]).reshape(-1)[:numel]


def schedule(tcfg: TrainConfig, step: int) -> torch.Tensor:
    """Warmup then cosine decay to 10%, a float32 0-d tensor on the host."""
    s = torch.tensor(float(step), dtype=torch.float32)
    warm = torch.clamp(s / float(max(tcfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp(
        (s - tcfg.warmup_steps) / float(max(tcfg.total_steps - tcfg.warmup_steps, 1)), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return tcfg.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(flat_grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sq = None
    for g in flat_grads:
        part = torch.sum(torch.square(g.to(torch.float32)))
        sq = part if sq is None else sq + part
    return torch.sqrt(sq)


def global_norm_sharded(flat_grads: Sequence[torch.Tensor], specs: Sequence[tuple],
                        mesh) -> torch.Tensor:
    """:func:`global_norm` of gradients split over ``mesh``: ``flat_grads``
    this rank's elements of each leaf, ``specs`` each leaf's spec.  Each
    element is counted once (the module's note)."""
    from repro_torch.distributed import sharding

    names = mesh.mesh_dim_names
    sq = None
    for g, spec in zip(flat_grads, specs):
        part = torch.sum(torch.square(g.to(torch.float32)))
        split = {a for e in spec for a in sharding.spec_axes(e)}
        if any(a not in split and sharding.mesh_axis(mesh, a).index for a in names):
            part = torch.zeros_like(part)  # another rank of the axis counts this replica
        sq = part if sq is None else sq + part
    for a in names:
        sq = sharding.all_reduce(sq, sharding.mesh_axis(mesh, a))
    return torch.sqrt(sq)


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One leaf, flattened: the per-layer tensors of a stacked leaf in layer order."""
    if len(tensors) == 1:
        return tensors[0].reshape(-1)
    return torch.cat([t.reshape(-1) for t in tensors])


def flatten_leaves(leaves, tensors: dict) -> list:
    """``tensors`` (by the port's parameter names) as one flat tensor per leaf."""
    return [_flat([tensors[n] for n in leaf.names]) for leaf in leaves]


def _zeros_state(numel: int, device, bits: int):
    z = torch.zeros((numel,), dtype=torch.float32, device=device)
    return q8(z) if bits == 8 else z


def init(leaves, params: dict, tcfg: TrainConfig) -> OptState:
    """Zero moments for every leaf of ``leaves`` (``reference_leaves``);
    ``params`` maps the port's parameter names to tensors."""
    mu, nu = [], []
    for leaf in leaves:
        numel = sum(params[n].numel() for n in leaf.names)
        device = params[leaf.names[0]].device
        mu.append(_zeros_state(numel, device, tcfg.opt_state_bits))
        nu.append(_zeros_state(numel, device, tcfg.opt_state_bits))
    return OptState(torch.zeros((), dtype=torch.int64), mu, nu)


def _moment(state) -> torch.Tensor:
    """A float32 moment's flat values: itself, or a ``Placed`` leaf's block."""
    return state if isinstance(state, torch.Tensor) else state.local.reshape(-1)


def _adam(g, m, v, p32, lr, c1, c2, decay, tcfg):
    m = tcfg.b1 * m + (1 - tcfg.b1) * g
    v = tcfg.b2 * v + (1 - tcfg.b2) * torch.square(g)
    step_dir = (m / c1) / (torch.sqrt(v / c2) + 1e-8)
    return m, v, p32 - lr * (step_dir + decay * p32)


@torch.no_grad()
def update(leaves, params: dict, flat_g: Sequence[torch.Tensor], opt: OptState,
           tcfg: TrainConfig, *, mesh=None):
    """One AdamW step: the parameters in ``params`` (by name) are updated in place.

    ``flat_g`` holds one flat gradient per leaf (:func:`flatten_leaves`), in
    any float dtype.  Returns ``(new_opt_state, metrics)`` with metrics
    ``lr`` and ``grad_norm``.  With ``mesh`` it is the step on this rank's
    shards (the module's note): ``leaves`` the ``sharding.LeafSpec`` of
    every leaf, ``params`` the placed local parameters, ``flat_g`` this
    rank's gradient elements of each leaf; a float32 moment is a ``Placed``
    block (replaced by a new one), an 8-bit one whole.
    """
    import dataclasses

    from repro_torch.distributed import sharding

    step = int(opt.step) + 1
    device = params[leaves[0].names[0]].device
    lr = schedule(tcfg, step).to(device)
    if mesh is None:
        gnorm = global_norm(flat_g)
    else:
        gnorm = global_norm_sharded(flat_g, [leaf.spec for leaf in leaves], mesh)
    if tcfg.grad_clip:
        clip = torch.clamp(_const(tcfg.grad_clip, gnorm) / torch.clamp_min(gnorm, 1e-9), max=1.0)
    else:
        clip = _const(1.0, gnorm)
    step_f = torch.tensor(float(step), dtype=torch.float32)
    c1 = (1.0 - torch.pow(torch.tensor(tcfg.b1, dtype=torch.float32), step_f)).to(device)
    c2 = (1.0 - torch.pow(torch.tensor(tcfg.b2, dtype=torch.float32), step_f)).to(device)

    new_mu, new_nu = [], []
    for leaf, g, mu, nu in zip(leaves, flat_g, opt.mu, opt.nu):
        tensors = [params[n] for n in leaf.names]
        g = g.to(torch.float32) * clip
        p32 = _flat(tensors).to(torch.float32)
        decay = tcfg.weight_decay if leaf.ndim >= 2 else 0.0  # no decay on norms/bias
        is_q8 = isinstance(mu, Q8)
        whole = mesh is not None and is_q8  # the whole leaf's update (the module's note)
        if whole:
            local = ((len(tensors),) if leaf.stacked else ()) + tuple(tensors[0].shape)
            g, p32 = (sharding.gather_block(x.reshape(local), leaf.spec, mesh).reshape(-1)
                      for x in (g, p32))
        if is_q8:
            m, v = dq8(mu, g.numel()), dq8(nu, g.numel())
        else:
            m, v = _moment(mu), _moment(nu)
        m, v, newp = _adam(g, m, v, p32, lr, c1, c2, decay, tcfg)
        if whole:
            newp = sharding.local_block(newp.reshape(leaf.shape), leaf.spec, mesh).reshape(-1)
        offset = 0
        for t in tensors:
            t.copy_(newp[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()
        for old, new, out in ((mu, m, new_mu), (nu, v, new_nu)):
            if is_q8:
                out.append(q8(new))
            elif isinstance(old, torch.Tensor):
                out.append(new)
            else:
                out.append(dataclasses.replace(old, local=new.reshape(old.local.shape)))
    metrics = {"lr": lr, "grad_norm": gnorm}
    return OptState(torch.tensor(step, dtype=torch.int64), new_mu, new_nu), metrics


def from_reference(step: int, mu: Sequence, nu: Sequence, *, device=None) -> OptState:
    """The port's state from the reference's ``OptState``, given as its step
    and its two moment trees' leaves in ``jax.tree_util.tree_leaves`` order
    (numpy arrays; an 8-bit moment as a ``(code, scale)`` pair), which is
    the order of ``reference_leaves``."""

    def one(x):
        if isinstance(x, tuple):
            code, scale = x
            return Q8(torch.as_tensor(code, device=device).to(torch.int8),
                      torch.as_tensor(scale, device=device).to(torch.float32))
        return torch.as_tensor(x, device=device).to(torch.float32).reshape(-1)

    return OptState(torch.tensor(int(step), dtype=torch.int64), [one(x) for x in mu],
                    [one(x) for x in nu])
