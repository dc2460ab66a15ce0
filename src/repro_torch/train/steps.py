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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.layers import fold_seed
from repro_torch.models.registry import Model, reference_leaves
from repro_torch.optim import adamw, compress
from repro_torch.train.losses import chunked_cross_entropy

__all__ = [
    "AUX_COEF", "TrainState", "init_train_state", "loss_fn",
    "make_decode_step", "make_prefill_step", "make_train_step", "mrope_positions",
]

AUX_COEF = 0.01


class TrainState(NamedTuple):
    params: torch.nn.Module  # a Transformer or EncoderDecoder, updated in place by the step
    opt: adamw.OptState
    comp: Optional[compress.CompressState]
    seed: int  # the run's seed: each step's noise seed is fold_seed(seed, step)
    step: torch.Tensor  # int64 0-d, on the host


def init_train_state(model: Model, tcfg: TrainConfig, seed: int, *, device=None) -> TrainState:
    """Seeded parameters on ``device`` (default ``cuda``), zero moments and
    residuals, step 0."""
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


def _head_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head_w


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
    ce = chunked_cross_entropy(hidden, _head_matrix(params, cfg), batch["labels"],
                               softcap=cfg.final_logit_softcap)
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


def make_train_step(model: Model, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds ``tokens`` and ``labels`` (B, S) on the parameters' device, and
    ``src_embeds`` (B, S_src, D) for an encoder-decoder."""
    accum = max(1, tcfg.grad_accum)

    def step_fn(state: TrainState, batch: dict):
        params = state.params
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
        if comp is not None:
            grads, comp, cmetrics = compress.compress_grads(grads, comp)
        named = dict(params.named_parameters())
        opt, ometrics = adamw.update(leaves, named, grads, state.opt, tcfg)
        metrics = {"loss": loss, **parts, **ometrics, **cmetrics}
        return TrainState(params, opt, comp, state.seed, state.step + 1), metrics

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
        caches = model.init_caches(b, max_seq, cache_dtype, tokens.device, mem_len=mem_len)
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
