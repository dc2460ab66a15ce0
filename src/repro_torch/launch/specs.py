"""Shape-and-dtype stand-ins and the specs of every (architecture x shape) cell.

Counterpart of ``repro/launch/specs.py``.  The stand-ins are meta tensors
(a shape and a dtype, no storage); the specs are
:mod:`repro_torch.distributed.sharding` specs, one axis entry per
dimension.

Cache rule, as the reference's (each entry degrades through
``resolve_spec`` where the mesh axis does not divide the dimension), on
the reference's cache tree, where the layers of a scanned group are
stacked on a leading axis:

  trailing 4 dims  (B, S, KV, hd) or (B, H, P, N) -> (DP, TP, None, None)
    (the KV cache's sequence axis, or the SSD state's heads, over model;
    the batch over data)
  3 dims           (B, K-1, C)                    -> (DP, None, TP)
  2 dims           (B, W)                         -> (DP, TP)

A stacked 3-d cache (layers, B, K-1, C) has 4 dims, so the first rule
puts DP on its layers, as the reference's does (see the note on stacked
leaves in ``distributed/sharding.py``).  :func:`cache_leaves` maps the
port's one-cache-per-layer list onto that tree.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (
    DP, TP, leaf_specs, mesh_axis_sizes, resolve_spec,
)

__all__ = [
    "ENC_MEM_LEN_DECODE", "CacheLeaf", "batch_specs", "cache_leaves", "cache_specs",
    "decode_input_specs", "input_specs", "params_specs", "state_specs",
]

# encoder-memory length for encoder-decoder *decode* cells (the source is
# fixed while the decoder streams); train and prefill cells use src_len == seq_len
ENC_MEM_LEN_DECODE = 4096


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype,
                       device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch of a *train or prefill* step as meta tensors (int32 ids,
    as the reference's stand-ins)."""
    gb, s = shape.global_batch, shape.seq_len
    out: dict = {}
    if cfg.is_encdec:
        out["tokens"] = _sds((gb, s), torch.int32)
        out["src_embeds"] = _sds((gb, s, cfg.d_model), cfg.dtype)
        out["src_pos"] = _sds((gb, s), torch.int32)
    elif cfg.frontend:  # vlm: precomputed patch embeddings for the stream
        out["embeds"] = _sds((gb, s, cfg.d_model), cfg.dtype)
        out["tokens"] = _sds((gb, s), torch.int32)
    else:
        out["tokens"] = _sds((gb, s), torch.int32)
    if shape.kind == "train":
        out["labels"] = _sds((gb, s), torch.int32)
    return out


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    gb = shape.global_batch
    return {"token": _sds((gb, 1), torch.int32), "pos": _sds((), torch.int32)}


def batch_specs(batch: dict, mesh) -> dict:
    """name -> spec: the batch dimension over DP."""
    sizes = mesh_axis_sizes(mesh)
    out = {}
    for name, x in batch.items():
        spec = (DP,) + (None,) * (x.ndim - 1) if x.ndim else ()
        out[name] = resolve_spec(spec, tuple(x.shape), sizes)
    return out


def params_specs(params, mesh, *, fsdp: bool = True) -> list:
    """``sharding.leaf_specs``: one per leaf of the reference's tree."""
    return leaf_specs(params, mesh, fsdp=fsdp)


@dataclasses.dataclass(frozen=True)
class CacheLeaf:
    """One leaf of the reference's cache tree and the port's tensors in it."""

    path: tuple  # e.g. ("scan", "sub0", "k"), ("rem", 0, "h"), ("self_kv", "k")
    tensors: tuple  # the port's per-layer tensors, in layer order for a stacked leaf
    stacked: bool

    @property
    def shape(self) -> tuple:
        one = tuple(self.tensors[0].shape)
        return (len(self.tensors),) + one if self.stacked else one

    @property
    def dtype(self) -> torch.dtype:
        return self.tensors[0].dtype


def cache_leaves(cfg: ModelConfig, caches: list) -> list:
    """The port's caches (one per layer, ``Model.init_caches``; meta
    tensors will do) as the leaves of the reference's cache tree, in
    ``tree_leaves`` order: ``rem`` before ``scan``, ``sub<i>`` in key
    order, a cache's fields in order; an encoder-decoder's ``DecCache``
    fields stacked over every decoder layer."""
    if cfg.is_encdec:
        fields = (("self_kv", "k"), ("self_kv", "v"), ("cross_k",), ("cross_v",))

        def get(c, f):
            return getattr(c.self_kv, f[1]) if f[0] == "self_kv" else getattr(c, f[0])

        return [CacheLeaf(f, tuple(get(c, f) for c in caches), True) for f in fields]
    period = len(cfg.layer_pattern)
    repeats = cfg.num_layers // period if cfg.scan_layers else 0
    out = []
    for j, i in enumerate(range(repeats * period, cfg.num_layers)):
        for name in caches[i]._fields:
            out.append(CacheLeaf(("rem", j, name), (getattr(caches[i], name),), False))
    for sub in sorted(range(period if repeats else 0), key=lambda i: f"sub{i}"):
        for name in caches[sub]._fields:
            layers = tuple(getattr(caches[r * period + sub], name) for r in range(repeats))
            out.append(CacheLeaf(("scan", f"sub{sub}", name), layers, True))
    return out


def _cache_rule(nd: int) -> tuple:
    if nd >= 4:
        return (None,) * (nd - 4) + (DP, TP, None, None)
    if nd == 3:
        return (DP, None, TP)
    if nd == 2:
        return (DP, TP)
    return (None,) * nd


def cache_specs(cfg: ModelConfig, caches: list, mesh) -> list:
    """``(CacheLeaf, spec over its stacked shape)`` for every leaf of
    :func:`cache_leaves`."""
    sizes = mesh_axis_sizes(mesh)
    return [(leaf, resolve_spec(_cache_rule(len(leaf.shape)), leaf.shape, sizes))
            for leaf in cache_leaves(cfg, caches)]


def state_specs(params, mesh, *, fsdp: bool = True) -> dict:
    """The train state's specs: the parameters' (``sharding.leaf_specs``);
    each AdamW moment mirrors its leaf's spec over the leaf's (stacked)
    shape; the step is replicated."""
    leaves = leaf_specs(params, mesh, fsdp=fsdp)
    mirror = [ls.spec if len(ls.shape) else () for ls in leaves]
    return {"params": leaves, "mu": mirror, "nu": list(mirror), "step": ()}
