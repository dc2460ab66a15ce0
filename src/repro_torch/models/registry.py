"""Model registry: one handle over the decoder stack.

Counterpart of ``repro/models/registry.py``.  ``build_model(cfg)`` returns
a :class:`Model` whose methods take the parameters (a
:class:`~repro_torch.models.transformer.Transformer` module) explicitly,
as the reference's take its parameter tree, so the step factories and the
scheduler read the same in both packages.

:func:`from_jax_params` loads the JAX package's parameter tree, converted
to nested dicts of numpy arrays by the caller, into the port.  The
reference stacks each layer group on a leading axis for ``lax.scan``
(``params["scan"]["sub<i>"]``, remainder layers in ``params["rem"]``);
the loader unstacks them into one block per layer, whatever the period:
recurrentgemma's (rglru, rglru, attn_local) groups with their remainder
layers, or mamba2's period of one.

:func:`reference_leaves` names, for each leaf of that tree in
``jax.tree_util.tree_leaves`` order, the port's parameters it holds (one
per layer for a stacked leaf).  The optimizer keys its state and its
weight-decay rule on it, and :func:`to_jax_layout` (the loader's inverse,
for parameters and gradients) stacks the port's tensors back into the
reference's tree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Transformer, block_kinds, init_cache

__all__ = ["Leaf", "Model", "build_model", "from_jax_params", "reference_leaves", "to_jax_layout"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init_params(self, seed: int = 0, *, device=None) -> Transformer:
        """Seeded random weights on ``device`` (default ``cuda``)."""
        return Transformer.init(self.cfg, seed=seed, device=resolve_device(device))

    def ctx(self, generator: Optional[torch.Generator] = None, *,
            seed: Optional[int] = None) -> Ctx:
        return Ctx(cfg=self.cfg, generator=generator, seed=seed)

    def forward(self, params: Transformer, tokens, positions, ctx: Ctx, *, embeds=None,
                caches=None, cache_pos=None):
        """Returns (hidden (B, S, D), caches, aux loss); ``embeds`` take the
        place of ``tokens`` when given."""
        return params(tokens, positions, ctx, embeds=embeds, caches=caches,
                      cache_pos=cache_pos)

    def lm_head(self, params: Transformer, hidden: torch.Tensor) -> torch.Tensor:
        return params.lm_head(hidden)

    def init_caches(self, batch: int, max_seq: int, dtype, device) -> list:
        """One zero cache per layer, by its kind: KV (B, max_seq, KV, hd) for
        attention, conv inputs and a float32 state for RG-LRU and SSD."""
        return [init_cache(self.cfg, kind, batch, max_seq, dtype, device)
                for kind in block_kinds(self.cfg)]

    def param_count(self, params: Transformer) -> int:
        return sum(p.numel() for p in params.parameters())


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)


# leaves the reference keeps float32 in every model: the MoE router
# (``moe.init_moe``), the RG-LRU's Lambda and the SSD's A, D and dt bias
_FLOAT32_LEAVES = ("router", "lru_a", "ssm_a", "ssm_d", "dt_bias")


def _tensor_tree(tree, dtype, device, key=None):
    """numpy leaves as tensors in ``dtype``, but ``_FLOAT32_LEAVES``."""
    if isinstance(tree, dict):
        return {k: _tensor_tree(v, dtype, device, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensor_tree(v, dtype, device) for v in tree]
    if key in _FLOAT32_LEAVES:
        dtype = torch.float32
    arr = np.array(tree, copy=True)
    if arr.dtype.kind not in "biuf":  # e.g. ml_dtypes bfloat16: widen losslessly first
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def from_jax_params(tree: dict, cfg: ModelConfig, *, device=None) -> Transformer:
    """Load the reference's parameter tree (numpy leaves) into the port."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    period = len(cfg.layer_pattern)
    repeats = cfg.num_layers // period if "scan" in tree else 0
    blocks = []
    for r in range(repeats):
        for i in range(period):
            stacked = tree["scan"][f"sub{i}"]
            blocks.append(_unstack(stacked, r))
    blocks.extend(tree.get("rem", []))
    if len(blocks) != len(block_kinds(cfg)):
        raise ValueError(f"tree holds {len(blocks)} blocks, {cfg.name} has {cfg.num_layers}")
    tensors = {
        "embed": tree["embed"],
        "final_norm": tree["final_norm"],
        "blocks": blocks,
    }
    if "lm_head" in tree:
        tensors["lm_head"] = tree["lm_head"]
    return Transformer(cfg, _tensor_tree(tensors, dtype, dev))


def _unstack(tree, index: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, index) for k, v in tree.items()}
    return np.asarray(tree)[index]


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the reference's parameter tree and the port's tensors in it."""

    path: tuple  # key path in the reference's tree, e.g. ("scan", "sub0", "attn", "wq")
    names: tuple  # the port's parameter names, in layer order for a stacked leaf
    ndim: int  # the leaf's rank in the reference's tree (stacking adds one)


def reference_leaves(params: Transformer) -> list:
    """The reference's parameter leaves in ``tree_leaves`` order (dict keys
    sorted at every level), for the config's ``scan_layers``: with it, the
    ``num_layers // len(layer_pattern)`` repeats of each pattern position
    are stacked on a leading axis (``params["scan"]["sub<i>"]``) and the
    remainder layers stay in ``params["rem"]``, as ``init_params`` does."""
    cfg = params.cfg
    named = dict(params.named_parameters())
    period = len(cfg.layer_pattern)
    repeats = cfg.num_layers // period if cfg.scan_layers else 0

    def block_paths(i):
        return sorted(tuple(n.split(".")) for n, _ in params.layers[i].named_parameters())

    def dims(name):
        return named[name].ndim

    out = [Leaf(("embed",), ("embed",), dims("embed")),
           Leaf(("final_norm",), ("final_norm",), dims("final_norm"))]
    if params.lm_head_w is not None:
        out.append(Leaf(("lm_head",), ("lm_head_w",), dims("lm_head_w")))
    for j, i in enumerate(range(repeats * period, cfg.num_layers)):
        for path in block_paths(i):
            name = f"layers.{i}." + ".".join(path)
            out.append(Leaf(("rem", j, *path), (name,), dims(name)))
    for sub in sorted(range(period if repeats else 0), key=lambda i: f"sub{i}"):
        for path in block_paths(sub):
            names = tuple(f"layers.{r * period + sub}." + ".".join(path) for r in range(repeats))
            out.append(Leaf(("scan", f"sub{sub}", *path), names, dims(names[0]) + 1))
    return out


def to_jax_layout(tensors: dict, params: Transformer) -> dict:
    """The inverse of :func:`from_jax_params`: ``tensors`` (numpy arrays or
    tensors by the port's parameter names, e.g. parameters or their
    gradients) as the reference's nested tree of numpy arrays, stacked
    layers and all."""

    def host(x):
        if torch.is_tensor(x):
            x = x.detach().to("cpu")
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return np.asarray(x)

    tree: dict = {}
    for leaf in reference_leaves(params):
        arrs = [host(tensors[n]) for n in leaf.names]
        value = np.stack(arrs) if leaf.path[0] == "scan" else arrs[0]
        node = tree
        for key in leaf.path[:-1]:
            if key == "rem":
                node = node.setdefault("rem", [])
            elif isinstance(key, int):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, {})
        node[leaf.path[-1]] = value
    return tree
