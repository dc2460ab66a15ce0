"""Dry-run: size every (arch x shape x mesh) cell on the production meshes.

Counterpart of ``repro/launch/dryrun.py``.  For each cell it builds the
model on the ``meta`` device (shapes and dtypes, no storage, nothing
drawn), takes the production mesh (``launch/mesh.py``: the 16 x 16 pod,
or 2 x 16 x 16 across two pods, as axis sizes) and the specs of
``launch/specs.py``, and reports:

- per-device bytes of the parameters, the AdamW moments (two float32
  moments a parameter, train cells), the caches (prefill: the caches it
  writes; decode: the caches it reads) and the batch: each leaf's size
  over its shards, times its itemsize, on the reference's (stacked) tree;
- ``model_flops`` (6 N D to train, 2 N D to infer, N the active
  parameters: MoE counts its top-k experts);
- the compute term (the useful FLOPs a device does over ``HW.PEAK_FLOPS``)
  and the memory term (the per-device bytes, each read once, over
  ``HW.HBM_BW``), at the H100 constants of ``launch/mesh.py``.

The reference also reads FLOPs, HBM bytes and collective bytes off the
compiled HLO (``launch/hlo_analysis.py``).  The port counts them on one
device's sharded step instead (:func:`step_counts`): the step runs on
``meta`` tensors (nothing executes), its parameters placed by their specs
on the production mesh (``sharding.place_params`` on the
``AbstractMesh``, with or without FSDP as the cell), so every layer runs
on this device's blocks as it would on the mesh, tensor-parallel by its
module's rules (the dense and MoE decoders, the SSD, the RG-LRU and the
encoder-decoder alike; kimi-k2 with sequence-sharded residuals, as the
reference's ``PERF_SETTINGS`` size it: :data:`PERF_SETTINGS`).  Each
distinct layer kind is traced once: a step at one layer of that kind less
the step at no layer, multiplied by its count, at the per-device batch.

- ``flops_per_dev`` and ``bytes_per_dev``: the aten ops the step
  dispatches, the backward's too (``hlo_analysis.analyze``).  The bytes
  are the eager model's (every op moves its operands and its result), not
  the reference's fused-HLO model; the collectives' own buffers are among
  them.
- ``collective_bytes_per_dev``: the collectives the step issues, counted
  by kind as ``distributed.sharding`` issues them (``sharding.counting``),
  the backward's too: ``all-reduce`` and ``all-gather`` their result
  buffer's, and the FSDP gradients' reduce-scatters, which the port
  issues as all-reduces of the whole buffer (``sharding.RS_AS_ALL_REDUCE``),
  that buffer's, the data axis's size times what the reference's GSPMD
  reduce-scatter moves.  The collective term is their sum over
  ``HW.NVLINK_BW``.

Usage:
  python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b --mesh single
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all --mesh both --out results.jsonl
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config, list_archs, shapes_for
from repro_torch.distributed.sharding import mesh_axis_sizes
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import block_kinds

__all__ = ["PERF_SETTINGS", "cell_bytes", "model_flops", "size_cell", "step_counts", "main"]

# the config settings a cell is sized with, by arch: the reference's
# ``PERF_SETTINGS`` extras (its train accumulation is not a config field)
PERF_SETTINGS = {"kimi-k2-1t-a32b": {"seq_shard_residuals": True}}


def model_flops(cfg, shape, kind: str) -> float:
    """6·N_active·D (train) / 2·N_active·D (inference) useful-FLOPs floor."""
    # active params: embeddings excluded (lookup), MoE counts top-k experts
    d, L = cfg.d_model, cfg.num_layers
    attn = 0
    if cfg.num_heads:
        attn = d * cfg.head_dim * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
    if cfg.num_experts:
        ffn = 3 * d * cfg.moe_d_ff * cfg.num_experts_per_tok
    elif cfg.d_ff:
        ffn = 3 * d * cfg.d_ff
    else:
        ffn = 0
    if "rglru" in cfg.layer_pattern:
        w = cfg.lru_width
        rec = 2 * d * w + 2 * w * w + w * d
        n_rec = sum(k == "rglru" for k in cfg.layer_pattern) / len(cfg.layer_pattern)
        n_att = 1 - n_rec
        per_layer = n_rec * (rec + ffn) + n_att * (attn + ffn)
    elif "ssd" in cfg.layer_pattern:
        di = cfg.d_inner or 2 * d
        per_layer = d * (2 * di + 2 * cfg.ssm_state + (cfg.ssm_heads or 1)) + di * d
    else:
        per_layer = attn + ffn
    n_active = L * per_layer
    if cfg.is_encdec:
        n_active += cfg.encoder_layers * (attn + ffn) + L * attn  # enc + cross
    n_active += cfg.d_model * cfg.vocab_size  # lm head matmul is real compute
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def _shards(spec: tuple, sizes: dict) -> int:
    n = 1
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            n *= sizes[axis]
    return n


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _bytes(shape: tuple, dtype: torch.dtype, spec: tuple, sizes: dict) -> int:
    numel = math.prod(shape)
    shards = _shards(spec, sizes)
    assert numel % shards == 0, (shape, spec)
    return numel // shards * _itemsize(dtype)


def cell_bytes(cfg, shape, mesh, *, fsdp: bool = True) -> dict:
    """Per-device bytes of one cell by part: params, opt (the AdamW
    moments), caches, batch, and their total."""
    sizes = mesh_axis_sizes(mesh)
    model = build_model(cfg)
    params = model.init_params(0, device="meta")
    named = dict(params.named_parameters())
    kind = shape.kind
    out = {"params": 0, "opt": 0, "caches": 0, "batch": 0}
    for ls in S.params_specs(params, mesh, fsdp=fsdp):
        out["params"] += _bytes(ls.shape, named[ls.names[0]].dtype, ls.spec, sizes)
        if kind == "train":  # mu and nu, float32, mirroring the leaf's spec
            out["opt"] += 2 * _bytes(ls.shape, torch.float32, ls.spec, sizes)
    if kind == "train":
        batch = S.input_specs(cfg, shape)
    else:
        mem_len = 0
        if cfg.is_encdec:
            mem_len = shape.seq_len if kind == "prefill" else S.ENC_MEM_LEN_DECODE
        caches = model.init_caches(shape.global_batch, shape.seq_len,
                                   getattr(torch, cfg.dtype), "meta", mem_len=mem_len)
        for leaf, spec in S.cache_specs(cfg, caches, mesh):
            out["caches"] += _bytes(leaf.shape, leaf.dtype, spec, sizes)
        batch = (S.input_specs(cfg, shape) if kind == "prefill"
                 else S.decode_input_specs(cfg, shape))
    for name, spec in S.batch_specs(batch, mesh).items():
        out["batch"] += _bytes(tuple(batch[name].shape), batch[name].dtype, spec, sizes)
    out["total"] = sum(out.values())
    return out


def _depths(cfg) -> tuple:
    """``(base, {kind: (cfg with one more layer of kind, count)})``: the
    configs whose difference is one layer of each distinct kind, and how
    many layers of it ``cfg`` has beyond ``base``.  A decoder stack's base
    has no layer; an encoder-decoder's keeps one decoder layer (its caches
    and memory need one), and its kinds are ``enc`` and ``dec``."""
    rep = dataclasses.replace
    if cfg.is_encdec:
        base = rep(cfg, encoder_layers=0, num_layers=1)
        return base, {"enc": (rep(base, encoder_layers=1), cfg.encoder_layers),
                      "dec": (rep(base, num_layers=2), cfg.num_layers - 1)}
    kinds = block_kinds(cfg)
    return rep(cfg, num_layers=0), {
        k: (rep(cfg, num_layers=1, layer_pattern=(k,)), kinds.count(k))
        for k in dict.fromkeys(kinds)}


def _step(cfg, shape, batch: int, mesh=None, fsdp: bool = True):
    """``(fn, args)`` of one device's step of ``shape.kind`` on meta tensors
    at ``batch`` rows: the loss and its gradients (train), the prefill, or
    one decode step over a ``shape.seq_len`` cache; with ``mesh`` the
    sharded step, its parameters this device's blocks (FSDP-split with
    ``fsdp``) and its caches its shard."""
    from repro_torch.distributed import sharding
    from repro_torch.train import steps

    model = build_model(cfg)
    params = model.init_params(0, device="meta")
    ax = None
    if mesh is not None:
        params = sharding.place_params(params, mesh, fsdp=fsdp)
        ax = sharding.model_axis(mesh)
    small = dataclasses.replace(shape, global_batch=batch)
    if shape.kind == "train":
        data = {k: v.to(torch.int64) if not v.is_floating_point() else v
                for k, v in S.input_specs(cfg, small).items()}

        def train(params, data):
            loss, _ = steps.loss_fn(params, data, None, model)
            return torch.autograd.grad(loss, list(params.parameters()), allow_unused=True)

        return train, [params, data]
    if shape.kind == "prefill":
        data = {k: v.to(torch.int64) if not v.is_floating_point() else v
                for k, v in S.input_specs(cfg, small).items()}
        prefill = steps.make_prefill_step(model, shape.seq_len, mem_len=shape.seq_len)
        return (lambda params, data: prefill(params, data)), [params, data]
    mem_len = S.ENC_MEM_LEN_DECODE if cfg.is_encdec else 0
    caches = model.init_caches(batch, shape.seq_len, getattr(torch, cfg.dtype), "meta",
                               mem_len=mem_len, ax=ax)
    token = torch.zeros((batch, 1), dtype=torch.int64, device="meta")
    decode = steps.make_decode_step(model)
    return (lambda params, caches, token: decode(params, caches, token, shape.seq_len - 1)), \
        [params, caches, token]


def _count(cfg, shape, batch: int, mesh=None, fsdp: bool = True) -> tuple:
    """``(FLOPs, bytes, {collective kind: bytes})`` of one device's step of
    ``cfg`` (at its depth): the sharded step on ``mesh``, or the step whole
    on one device without it."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import hlo_analysis

    fn, args = _step(cfg, shape, batch, mesh, fsdp)
    with torch.set_grad_enabled(shape.kind == "train"), sharding.mesh_context(mesh), \
            sharding.counting() as counts:
        a = hlo_analysis.analyze(fn, args, where=False)
    return a.flops, a.bytes, counts


def step_counts(cfg, shape, mesh, *, fsdp: bool = True) -> dict:
    """One device's sharded step: FLOPs, bytes (``launch/hlo_analysis.py``)
    and collective bytes by kind, each distinct layer kind traced once at
    one layer and multiplied by its count, at the per-device batch (the
    batch over the data axes)."""
    sizes = mesh_axis_sizes(mesh)
    batch_spec = S.batch_specs({"x": torch.empty((shape.global_batch,), device="meta")},
                               mesh)["x"]
    batch = max(1, shape.global_batch // _shards(batch_spec, sizes))
    base_cfg, kinds = _depths(cfg)
    f0, b0, c0 = _count(base_cfg, shape, batch, mesh, fsdp)
    flops, nbytes, coll = f0, b0, collections.Counter(c0)
    for kind_cfg, count in kinds.values():
        f, b, c = _count(kind_cfg, shape, batch, mesh, fsdp)
        flops += count * (f - f0)
        nbytes += count * (b - b0)
        for k in set(c) | set(c0):
            coll[k] += count * (c[k] - c0[k])
    layers = ({"enc": cfg.encoder_layers, "dec": cfg.num_layers} if cfg.is_encdec
              else {k: count for k, (_, count) in kinds.items()})
    return {"flops": flops, "bytes": nbytes, "batch_per_dev": batch, "layer_kinds": layers,
            "collectives": {k: float(v) for k, v in sorted(coll.items())}}


def size_cell(arch: str, shape_name: str, multi_pod: bool, *, fsdp: bool = True,
              steps: bool = True) -> dict:
    """One cell's record (see the module's note); ``steps=False`` leaves the
    step's FLOPs and bytes out (null), for callers that size memory only."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), **PERF_SETTINGS.get(arch, {}))
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    kind = shape.kind
    per_dev = cell_bytes(cfg, shape, mesh, fsdp=fsdp)
    mf = model_flops(cfg, shape, kind)
    step = step_counts(cfg, shape, mesh, fsdp=fsdp) if steps else dict.fromkeys(
        ("flops", "bytes", "batch_per_dev", "layer_kinds", "collectives"))
    coll = step["collectives"]
    t_compute = mf / chips / HW.PEAK_FLOPS
    t_memory = per_dev["total"] / HW.HBM_BW
    t_coll = None if coll is None else sum(coll.values()) / HW.NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "chips": chips,
        "kind": kind,
        "fsdp": fsdp,
        "ok": True,
        "hw": HW.NAME,
        "per_device_bytes": per_dev,
        "per_device_gb": per_dev["total"] / 1e9,
        "fits": per_dev["total"] <= HW.HBM_BYTES,
        "model_flops_total": mf,
        # counted on the aten graph of one device's sharded step (launch/hlo_analysis.py)
        "flops_per_dev": step["flops"],
        "bytes_per_dev": step["bytes"],
        "batch_per_dev": step["batch_per_dev"],
        "layer_kinds": step["layer_kinds"],
        "collective_bytes_per_dev": coll,
        **({"collective_bytes_null_because": "steps not counted (steps=False)"}
           if coll is None else {}),
        "terms_s": terms,
        "dominant": max((k for k, v in terms.items() if v is not None), key=terms.get),
        "step_time_bound_s": max(v for v in terms.values() if v is not None),
        "host_s": time.perf_counter() - t0,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--shape", help="one shape cell (default: every cell of --arch)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fsdp", choices=["on", "off"], default="on",
                    help="ZeRO-3 parameter and moment sharding over the data axis")
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("give --arch (and optionally --shape) or --all")

    cells = []
    for arch in (list_archs() if args.all else [args.arch]):
        names = [args.shape] if args.shape and not args.all else list(shapes_for(get_config(arch)))
        cells += [(arch, s) for s in names]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    out_f = open(args.out, "a") if args.out else None
    n_fail = 0
    for arch, sname in cells:
        for mp in meshes:
            try:
                rec = size_cell(arch, sname, mp, fsdp=args.fsdp == "on")
            except Exception as e:  # noqa: BLE001 — report, continue
                rec = {"arch": arch, "shape": sname, "mesh": "multi" if mp else "single",
                       "ok": False, "error": f"{type(e).__name__}: {e}"}
                traceback.print_exc()
                n_fail += 1
            line = json.dumps(rec)
            print(line, flush=True)
            if out_f:
                out_f.write(line + "\n")
                out_f.flush()
    if out_f:
        out_f.close()
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
