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
the loader unstacks them into one block per layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Transformer, block_kinds

__all__ = ["Model", "build_model", "from_jax_params"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init_params(self, seed: int = 0, *, device=None) -> Transformer:
        """Seeded random weights on ``device`` (default ``cuda``)."""
        return Transformer.init(self.cfg, seed=seed, device=resolve_device(device))

    def ctx(self, generator: Optional[torch.Generator] = None) -> Ctx:
        return Ctx(cfg=self.cfg, generator=generator)

    def forward(self, params: Transformer, tokens, positions, ctx: Ctx, *, caches=None,
                cache_pos=None):
        """Returns (hidden (B, S, D), caches)."""
        return params(tokens, positions, ctx, caches=caches, cache_pos=cache_pos)

    def lm_head(self, params: Transformer, hidden: torch.Tensor) -> torch.Tensor:
        return params.lm_head(hidden)

    def init_caches(self, batch: int, max_seq: int, dtype, device) -> list:
        return [
            attention.init_kv_cache(self.cfg, batch, max_seq, dtype, device)
            for _ in range(self.cfg.num_layers)
        ]

    def param_count(self, params: Transformer) -> int:
        return sum(p.numel() for p in params.parameters())


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)


def _tensor_tree(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _tensor_tree(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensor_tree(v, dtype, device) for v in tree]
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
