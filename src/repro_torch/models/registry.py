"""Model registry: one handle over the decoder-only and encoder-decoder stacks.

Counterpart of ``repro/models/registry.py``.  ``build_model(cfg)`` returns
a :class:`Model` whose methods take the parameters (a
:class:`~repro_torch.models.transformer.Transformer` module, or an
:class:`~repro_torch.models.encdec.EncoderDecoder` when
``cfg.is_encdec``) explicitly, as the reference's take its parameter
tree, so the step factories and the scheduler read the same in both
packages.

:func:`from_jax_params` loads the JAX package's parameter tree, converted
to nested dicts of numpy arrays by the caller, into the port.  The
reference stacks each layer group on a leading axis for ``lax.scan``
(``params["scan"]["sub<i>"]``, remainder layers in ``params["rem"]``;
an encoder-decoder's two stacks in ``params["enc_scan"]`` and
``params["dec_scan"]``); the loader unstacks them into one block per
layer, whatever the period: recurrentgemma's (rglru, rglru, attn_local)
groups with their remainder layers, or mamba2's period of one.

:func:`reference_leaves` names, for each leaf of that tree in
``jax.tree_util.tree_leaves`` order, the port's parameters it holds (one
per layer for a stacked leaf).  The optimizer keys its state and its
weight-decay rule on it, and :func:`to_jax_layout` (the loader's inverse,
for parameters and gradients) stacks the port's tensors back into the
reference's tree.

Given a live ``mesh``, ``init_params`` and :func:`from_jax_params` place
each leaf's local block (``distributed.sharding.place_params``): the
weights are then this rank's blocks by their specs, and the layers run
tensor-parallel under ``sharding.mesh_context(mesh)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.models.encdec import EncoderDecoder, init_dec_caches
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Transformer, block_kinds, init_cache

__all__ = ["Leaf", "Model", "STACKS", "build_model", "from_jax_params", "reference_leaves",
           "to_jax_layout"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init_params(self, seed: int = 0, *, device=None, mesh=None):
        """Seeded random weights on ``device`` (default ``cuda``): a
        ``Transformer``, or an ``EncoderDecoder`` when ``cfg.is_encdec``;
        with ``mesh``, this rank's blocks of them (the module's note)."""
        stack = EncoderDecoder if self.cfg.is_encdec else Transformer
        params = stack.init(self.cfg, seed=seed, device=resolve_device(device))
        return params if mesh is None else _place(params, mesh)

    def ctx(self, generator: Optional[torch.Generator] = None, *,
            seed: Optional[int] = None) -> Ctx:
        return Ctx(cfg=self.cfg, generator=generator, seed=seed)

    def forward(self, params, tokens, positions, ctx: Ctx, *, embeds=None, src_embeds=None,
                src_pos=None, caches=None, cache_pos=None):
        """Returns (hidden (B, S, D), caches, aux loss); ``embeds`` take the
        place of ``tokens`` when given.  An encoder-decoder without caches
        encodes ``src_embeds`` (B, S_src, D) at ``src_pos`` and decodes over
        that memory; with caches it reads their cross K/V at memory
        positions ``arange(S_mem)``.  Its aux loss is 0."""
        if not self.cfg.is_encdec:
            return params(tokens, positions, ctx, embeds=embeds, caches=caches,
                          cache_pos=cache_pos)
        aux = torch.zeros((), dtype=torch.float32, device=params.embed.device)
        if caches is None:
            memory = params.encode(src_embeds, src_pos, ctx)
            hidden, _ = params.decode_forward(tokens, positions, src_pos, ctx, memory=memory)
            return hidden, None, aux
        b, mem_len = tokens.shape[0], caches[0].cross_k.shape[1]
        ax = sharding.model_axis() if sharding.is_placed(params) else None
        mem_len *= 1 if ax is None else ax.size  # each rank holds its slots (models/encdec.py)
        mem_pos = torch.arange(mem_len, device=tokens.device)[None, :].expand(b, mem_len)
        hidden, caches = params.decode_forward(tokens, positions, mem_pos, ctx, caches=caches,
                                               cache_pos=cache_pos)
        return hidden, caches, aux

    def lm_head(self, params, hidden: torch.Tensor) -> torch.Tensor:
        return params.lm_head(hidden)

    def init_caches(self, batch: int, max_seq: int, dtype, device, *, mem_len: int = 0,
                    ax=None) -> list:
        """One zero cache per layer, by its kind: KV (B, max_seq, KV, hd) for
        attention, conv inputs and a float32 state for RG-LRU and SSD; for
        an encoder-decoder a :class:`~repro_torch.models.encdec.DecCache`
        per decoder layer, with ``mem_len`` cross K/V slots.  With a model
        axis ``ax`` (placed parameters), this rank's shard of each: the KV
        and cross caches' sequence split over it (it must divide
        ``max_seq`` and ``mem_len``), the recurrent caches as
        ``models.transformer.init_cache`` places them."""
        if ax is not None:
            for what, n in (("max_seq", max_seq), ("mem_len", mem_len)):
                if n % ax.size:
                    raise ValueError(f"{what} {n} does not split over {ax.size} model ranks")
        if self.cfg.is_encdec:
            return init_dec_caches(self.cfg, batch, max_seq, mem_len, dtype, device, ax)
        return [init_cache(self.cfg, kind, batch, max_seq, dtype, device, ax)
                for kind in block_kinds(self.cfg)]

    def _encdec(self, what: str) -> None:
        if not self.cfg.is_encdec:
            raise ValueError(f"{self.cfg.name}: {what} needs an encoder-decoder config")

    def encode(self, params: EncoderDecoder, src_embeds, src_pos, ctx: Ctx) -> torch.Tensor:
        """The encoder's memory (B, S_src, D)."""
        self._encdec("encode")
        return params.encode(src_embeds, src_pos, ctx)

    def precompute_cross(self, params: EncoderDecoder, memory, ctx: Ctx) -> list:
        """Each decoder layer's cross K/V pair from the memory."""
        self._encdec("precompute_cross")
        return params.precompute_cross(memory, ctx)

    def param_count(self, params) -> int:
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


def _place(params, mesh):
    return sharding.place_params(params, mesh)


def from_jax_params(tree: dict, cfg: ModelConfig, *, device=None, mesh=None):
    """Load the reference's parameter tree (numpy leaves) into the port;
    with ``mesh``, this rank's blocks of it (the module's note)."""
    if mesh is not None:
        return _place(from_jax_params(tree, cfg, device=device), mesh)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    if cfg.is_encdec:
        tensors = {key: tree[key] for key in ("embed", "enc_final_norm", "final_norm", "lm_head")
                   if key in tree}
        tensors["enc"] = [_unstack(tree["enc_scan"], i) for i in range(cfg.encoder_layers)]
        tensors["dec"] = [_unstack(tree["dec_scan"], i) for i in range(cfg.num_layers)]
        return EncoderDecoder(cfg, _tensor_tree(tensors, dtype, dev))
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


# the reference's stacked subtrees: one leading layer axis on every leaf
STACKS = ("scan", "enc_scan", "dec_scan")


def reference_leaves(params) -> list:
    """The reference's parameter leaves in ``tree_leaves`` order (dict keys
    sorted at every level), for the config's ``scan_layers``: with it, the
    ``num_layers // len(layer_pattern)`` repeats of each pattern position
    are stacked on a leading axis (``params["scan"]["sub<i>"]``) and the
    remainder layers stay in ``params["rem"]``, as ``init_params`` does.
    An encoder-decoder's two stacks are stacked whatever ``scan_layers``
    says (``enc_scan``, ``dec_scan``), as ``encdec.init_params`` does."""
    cfg = params.cfg
    named = dict(params.named_parameters())
    if cfg.is_encdec:
        return _encdec_leaves(params, named)
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


def _encdec_leaves(params: EncoderDecoder, named: dict) -> list:
    tops = {"embed": "embed", "enc_final_norm": "enc_final_norm", "final_norm": "final_norm"}
    if params.lm_head_w is not None:
        tops["lm_head"] = "lm_head_w"
    stacks = {"enc_scan": params.enc_layers, "dec_scan": params.dec_layers}
    out = []
    for key in sorted([*tops, *stacks]):
        if key in tops:
            out.append(Leaf((key,), (tops[key],), named[tops[key]].ndim))
            continue
        module = "enc_layers" if key == "enc_scan" else "dec_layers"
        blocks = stacks[key]
        for path in sorted(tuple(n.split(".")) for n, _ in blocks[0].named_parameters()):
            names = tuple(f"{module}.{i}." + ".".join(path) for i in range(len(blocks)))
            out.append(Leaf((key, *path), names, named[names[0]].ndim + 1))
    return out


def to_jax_layout(tensors: dict, params) -> dict:
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
        value = np.stack(arrs) if leaf.path[0] in STACKS else arrs[0]
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
