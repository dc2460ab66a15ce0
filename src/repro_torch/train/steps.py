"""Train and serve step factories.

Counterpart of ``repro/train/steps.py``.  ``make_train_step`` builds the
training step: gradient-accumulation microbatches (gradients summed in
float32, then averaged), optional int8 error-feedback gradient
compression, AdamW (float32 or 8-bit moments) and the vocab-chunked CE.
Remat is applied per block by the model, per ``cfg.remat``.  Every
family trains: autograd reaches the RG-LRU's and the SSD's log-depth
scans (whole-tensor torch ops) and their float32 leaves, and an
encoder-decoder's loss runs the encoder over ``batch["src_embeds"]``.
The reference jits the step and returns a new state; here it runs
eagerly and updates the parameters in place (they are the state's
largest part, and an update in place saves a copy of them per step),
returning the state with its new optimizer state and step.

``make_prefill_step`` / ``make_decode_step`` are the serving pair: prefill
builds fresh caches, one per layer by its kind (KV, or RG-LRU / SSD
conv inputs and float32 state), and writes positions [0, S) (or, given
per-row true positions of left-padded prompts, masks the pads out of the
KV cache; a recurrent state takes every token in, pads included);
decode consumes one token per row at a scalar or per-row position and
carries every cache, recurrent ones by their single-step update.  An
encoder-decoder's prefill also runs the encoder over ``batch["src_embeds"]``
and puts each decoder layer's cross K/V, in the cache dtype, in its cache.
Under M-RoPE every step broadcasts its (B, S) positions to the (3, B, S)
t/h/w streams of a text-only sequence (t = h = w), as the reference does.

**The sharded step** (``make_train_step(..., mesh=)``) runs the same step
on a live (data, model) mesh, every rank on its own blocks: the state is
the ``Placed`` layout of ``checkpoint.manager.shard_train_state`` (so it
saves and restores elastically), the parameters are FSDP-split over
``data`` and TP-split over ``model`` by their specs, and each leaf is
gathered over ``data`` where a layer uses it, its gradient reduce-scattered
back (``distributed.sharding.use``).  The batch is this rank's rows of the
global batch as :func:`shard_batch` cuts them: with ``grad_accum > 1``
microbatch i holds rows ``[i B / accum, (i + 1) B / accum)`` of the
*global* batch, split over the data ranks, as the reference's scan over
``reshape(accum, B / accum)`` places them; the absmax and the ``inject``
draws are per microbatch, so membership is part of the function.  The
loss of each rank's rows is their sum over the global token count, and
the MoE's load-balance loss (every data rank's the same: its statistics
are averaged over the data ranks) enters each rank's loss as its share,
over the data rank count, so the data ranks' losses and gradients add up
to the global loss.  Every family trains so: the dense and MoE decoders,
mamba2's SSD, recurrentgemma's RG-LRU and the encoder-decoder (its batch
holds ``src_embeds``, cut by :func:`shard_batch` as the tokens are), each
layer tensor-parallel as its module's note says.  The serving pair takes
placed parameters under a mesh too: the caches are then each rank's shard
(``Model.init_caches(..., ax=)``: the KV and cross caches' sequence, the
recurrent caches' heads or channels).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.distributed import sharding
from repro_torch.models.layers import fold_seed
from repro_torch.models.registry import Model, reference_leaves
from repro_torch.models.transformer import head_matrix
from repro_torch.optim import adamw, compress
from repro_torch.train.losses import chunked_cross_entropy

__all__ = [
    "AUX_COEF", "TrainState", "init_train_state", "loss_fn",
    "make_decode_step", "make_prefill_step", "make_train_step", "mrope_positions",
    "shard_batch",
]

AUX_COEF = 0.01


class TrainState(NamedTuple):
    params: torch.nn.Module  # a Transformer or EncoderDecoder, updated in place by the step
    opt: adamw.OptState
    comp: Optional[compress.CompressState]
    seed: int  # the run's seed: each step's noise seed is fold_seed(seed, step)
    step: torch.Tensor  # int64 0-d, on the host


def init_train_state(model: Model, tcfg: TrainConfig, seed: int, *, device=None,
                     mesh=None) -> TrainState:
    """Seeded parameters on ``device`` (default ``cuda``), zero moments and
    residuals, step 0; with ``mesh``, this rank's blocks of that state
    (``shard_train_state``) for the sharded step."""
    if mesh is not None:
        from repro_torch.checkpoint.manager import shard_train_state

        return shard_train_state(init_train_state(model, tcfg, seed, device=device), mesh)
    params = model.init_params(seed, device=device)
    leaves = reference_leaves(params)
    named = dict(params.named_parameters())
    comp = None
    if tcfg.grad_compress_bits:
        numels = [sum(named[n].numel() for n in leaf.names) for leaf in leaves]
        comp = compress.init_state(numels, params.embed.device)
    return TrainState(params, adamw.init(leaves, named, tcfg), comp, seed,
                      torch.zeros((), dtype=torch.int64))


def mrope_positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """(B, S) positions as the model takes them: under M-RoPE the text-only
    streams (3, B, S) with t = h = w, else unchanged."""
    return pos[None].expand(3, *pos.shape) if cfg.use_mrope else pos


def _positions(cfg: ModelConfig, batch: dict) -> torch.Tensor:
    tokens = batch["tokens"]
    b, s = tokens.shape
    return mrope_positions(cfg, torch.arange(s, device=tokens.device)[None, :].expand(b, s))


def shard_batch(batch: dict, mesh, accum: int = 1) -> dict:
    """This rank's rows of a global ``batch`` for the sharded step, in
    microbatch order: of each of the ``accum`` microbatches (rows ``[i B /
    accum, (i + 1) B / accum)``) the data rank's contiguous share."""
    ax = sharding.mesh_axis(mesh, sharding.FSDP)
    size, index = (1, 0) if ax is None else (ax.size, ax.index)
    b = next(iter(batch.values())).shape[0]
    if b % (accum * size):
        raise ValueError(f"batch {b} does not split into {accum} microbatches over {size} "
                         f"data ranks")
    mb, per = b // accum, b // (accum * size)
    rows = torch.cat([torch.arange(i * mb + index * per, i * mb + (index + 1) * per)
                      for i in range(accum)])
    return {k: v[rows.to(v.device)] for k, v in batch.items()}


def loss_fn(params, batch: dict, seed: Optional[int], model: Model):
    """(loss, {"loss": ce, "aux": aux}): CE plus ``AUX_COEF`` times the MoE
    load-balance loss (0 without experts); ``seed`` seeds the stochastic
    modes' noise (``Ctx.seed``).  A frontend model takes ``batch["embeds"]``
    (B, S, D) in place of the token lookup when the batch has them; the
    positions are ``arange(S)`` per row (t = h = w under M-RoPE).  An
    encoder-decoder encodes ``batch["src_embeds"]`` (B, S_src, D) at
    ``src_pos = arange(S_src)`` and decodes the tokens over that memory."""
    cfg = model.cfg
    ctx = model.ctx(seed=seed)
    kwargs = {}
    if cfg.is_encdec:
        src = batch["src_embeds"]
        b, s_src = src.shape[:2]
        kwargs = dict(src_embeds=src,
                      src_pos=torch.arange(s_src, device=src.device)[None, :].expand(b, s_src))
    elif cfg.frontend:
        kwargs = dict(embeds=batch.get("embeds"))
    hidden, _, aux = model.forward(params, batch["tokens"], _positions(cfg, batch), ctx,
                                   **kwargs)
    w, vocab_axis = head_matrix(params, cfg)
    count = None
    if sharding.is_placed(params):  # this rank's rows over the global count (the note)
        rows = sharding.row_shard()[2]
        count = batch["labels"].numel() * rows
        aux = aux / torch.full((), float(rows), device=aux.device)  # this rank's share
    ce = chunked_cross_entropy(hidden, w, batch["labels"], softcap=cfg.final_logit_softcap,
                               vocab_axis=vocab_axis, count=count)
    loss = ce + AUX_COEF * aux
    return loss, {"loss": ce, "aux": aux}


def _grads(params, leaves, batch: dict) -> list:
    """The parameters' gradients, one flat tensor per reference leaf.  Only
    the token table of a frontend model fed ``batch["embeds"]`` may miss
    the loss (untied: nothing reads it); it gets a zero gradient, as
    ``jax.grad`` gives it.  Any other parameter without a gradient is cut
    off the loss by a fault, and raises."""
    may_miss = {"embed"} if params.cfg.frontend and "embeds" in batch else set()
    grads = {}
    for n, p in params.named_parameters():
        if p.grad is None and n not in may_miss:
            raise RuntimeError(f"parameter {n!r} has no gradient: the loss does not reach it")
        grads[n] = torch.zeros_like(p) if p.grad is None else p.grad
    return adamw.flatten_leaves(leaves, grads)


def _local_module(model: Model, placed: list, mesh):
    """The model's module holding the ``Placed`` parameter blocks of a
    sharded state (sharing their storage, under their own specs), which
    must lie on ``mesh``."""
    params = model.init_params(0, device="meta")
    names = [n for n, _ in params.named_parameters()]
    return sharding.place_params(params, mesh, blocks=dict(zip(names, placed)))


def make_train_step(model: Model, tcfg: TrainConfig, *, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds ``tokens`` and ``labels`` (B, S) on the parameters' device, and
    ``src_embeds`` (B, S_src, D) for an encoder-decoder.  With ``mesh`` it
    is the sharded step (the module's note): ``state`` from
    ``init_train_state(..., mesh=)`` or ``shard_train_state``, ``batch``
    this rank's rows from :func:`shard_batch`."""
    accum = max(1, tcfg.grad_accum)
    if mesh is not None:
        sharding.require_live(mesh, "the sharded train step")
    held: dict = {}

    def step_fn(state: TrainState, batch: dict):
        if mesh is None:
            params = state.params
        else:  # the module over the state's blocks, made once per list of blocks
            if held.get("placed") is not state.params:
                held.update(placed=state.params,
                            module=_local_module(model, state.params, mesh))
            params = held["module"]
        if mesh is None:
            return _step(params, state, batch)
        with sharding.mesh_context(mesh):
            return _step(params, state, batch)

    def _step(params, state: TrainState, batch: dict):
        leaves = reference_leaves(params)
        seed = fold_seed(state.seed, int(state.step))
        if accum == 1:
            params.zero_grad(set_to_none=True)
            loss, parts = loss_fn(params, batch, seed, model)
            loss.backward()
            grads = _grads(params, leaves, batch)
            loss, parts = loss.detach(), {k: v.detach() for k, v in parts.items()}
        else:
            b = batch["tokens"].shape[0]
            if b % accum:
                raise ValueError(f"batch {b} does not split into {accum} microbatches")
            grads = loss = None
            for i in range(accum):
                micro = {k: v.reshape(accum, b // accum, *v.shape[1:])[i]
                         for k, v in batch.items()}
                params.zero_grad(set_to_none=True)
                l, _ = loss_fn(params, micro, seed, model)
                l.backward()
                g = _grads(params, leaves, micro)
                grads = ([x.to(torch.float32) for x in g] if grads is None
                         else [a + x for a, x in zip(grads, g)])
                loss = l.detach() if loss is None else loss + l.detach()
            n = torch.full((), float(accum), dtype=torch.float32, device=loss.device)
            grads = [g / n for g in grads]
            loss = loss / n
            parts = {"loss": loss, "aux": torch.zeros_like(loss)}
        params.zero_grad(set_to_none=True)

        comp, cmetrics = state.comp, {}
        named = dict(params.named_parameters())
        if mesh is not None:
            leaves = params.placed_specs  # each leaf with the spec of its blocks
            # the data ranks' losses add up to the global mean (the note)
            data = sharding.mesh_axis(mesh, sharding.FSDP)
            loss = sharding.all_reduce(loss, data)
            parts = {k: sharding.all_reduce(v, data) for k, v in parts.items()}
        if comp is not None and mesh is None:
            grads, comp, cmetrics = compress.compress_grads(grads, comp)
        elif comp is not None:  # the per-tensor scale over the whole leaf
            local = [((len(ls.names),) if ls.stacked else ()) + tuple(named[ls.names[0]].shape)
                     for ls in leaves]
            whole = [sharding.gather_block(g.reshape(shape), ls.spec, mesh).reshape(-1)
                     for ls, g, shape in zip(leaves, grads, local)]
            whole, comp, cmetrics = compress.compress_grads(whole, comp)
            grads = [sharding.local_block(g.reshape(ls.shape), ls.spec, mesh).reshape(-1)
                     for ls, g in zip(leaves, whole)]
        opt, ometrics = adamw.update(leaves, named, grads, state.opt, tcfg,
                                     **({} if mesh is None else {"mesh": mesh}))
        new_params = params if mesh is None else state.params
        metrics = {"loss": loss, **parts, **ometrics, **cmetrics}
        return TrainState(new_params, opt, comp, state.seed, state.step + 1), metrics

    return step_fn


def make_prefill_step(model: Model, max_seq: int, *, mem_len: int = 0):
    """prefill(params, batch) -> (caches, last_token_logits (B, 1, V)).

    ``batch["positions"]`` (optional, (B, S)) gives per-row true position
    ids; pad slots carry negative ids and are masked out of the cache.  An
    encoder-decoder's batch also holds ``src_embeds`` and ``src_pos``: the
    encoder runs over them and each decoder cache takes its layer's cross
    K/V, cast to the cache dtype (its ``mem_len`` slots replaced).
    """
    cfg = model.cfg
    cache_dtype = getattr(torch, cfg.dtype)

    def prefill(params, batch: dict):
        tokens = batch["tokens"]
        b, s = tokens.shape
        ctx = model.ctx()
        ax = sharding.model_axis() if sharding.is_placed(params) else None
        caches = model.init_caches(b, max_seq, cache_dtype, tokens.device, mem_len=mem_len,
                                   ax=ax)  # with ax, this rank's shard of each
        if cfg.is_encdec:
            memory = model.encode(params, batch["src_embeds"], batch["src_pos"], ctx)
            cross = model.precompute_cross(params, memory, ctx)
            caches = [c._replace(cross_k=ck.to(cache_dtype), cross_v=cv.to(cache_dtype))
                      for c, (ck, cv) in zip(caches, cross)]
        if "positions" in batch:
            pos = batch["positions"].to(torch.int64)
            cache_pos = torch.zeros((b,), dtype=torch.int64, device=tokens.device)
        else:
            pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
            cache_pos = 0
        hidden, caches, _ = model.forward(params, tokens, mrope_positions(cfg, pos), ctx,
                                          caches=caches, cache_pos=cache_pos)
        return caches, model.lm_head(params, hidden[:, -1:, :])

    return prefill


def make_decode_step(model: Model):
    """decode(params, caches, token (B,1), pos, write_pos=None) -> (logits, caches).

    ``pos`` is a scalar (every row at the same position, which is also the
    write slot) or a per-row (B,) tensor of true positions, with
    ``write_pos`` (default ``pos``) each row's physical write slot.
    """

    cfg = model.cfg

    def decode(params, caches, token: torch.Tensor, pos, write_pos=None):
        b = token.shape[0]
        ctx = model.ctx()
        if torch.is_tensor(pos) and pos.ndim >= 1:
            pos = pos.to(torch.int64)
            p = pos[:, None]
            cache_pos = pos if write_pos is None else write_pos.to(torch.int64)
        else:
            p = torch.full((b, 1), int(pos), dtype=torch.int64, device=token.device)
            cache_pos = int(pos)
        hidden, caches, _ = model.forward(params, token, mrope_positions(cfg, p), ctx,
                                          caches=caches, cache_pos=cache_pos)
        return model.lm_head(params, hidden), caches

    return decode
