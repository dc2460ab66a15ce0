"""Vocab-chunked cross-entropy.

Counterpart of ``repro/train/losses.py``.  For vocab sizes up to 256k,
materializing (B, S, V) f32 logits dominates activation memory.  The loss
is therefore computed in vocab chunks: a running (max, sumexp) pair
implements a streaming logsumexp, and the label logit is gathered from
whichever chunk owns it.  Each chunk runs under ``torch.utils.checkpoint``,
so the backward recomputes one chunk's logits at a time and peak live
logits are (B*S, V_chunk), as under the reference's rematerialised scan.

The last chunk holds only the columns that exist (the reference pads it
with -inf columns, which add exactly nothing to the max, the sum or the
label).  ``h2 @ wck`` is a plain product outside any kernel, as in the
reference, so it goes to ``torch.matmul``.

**Vocab-parallel** (``vocab_axis``): ``w`` is this rank's slice of the
vocabulary, ``[r V/m, (r+1) V/m)``, as the reference's ``constrain(wck,
None, TP)`` places the chunks.  Each rank streams its slice in chunks
(the backward still recomputes one chunk at a time) to its own
logsumexp; the ranks' logsumexps combine as one more: their max M (an
all-reduce MAX, held constant) plus the log of the all-reduced sum of
exp(lse_r - M), and the label logit is an all-reduce sum of the one
rank's whose slice holds it (zeros elsewhere).  On one rank this is the
unsharded loss and gradient bit for bit (exp(0) = 1, log(1) = 0).  The
hidden states enter through ``sharding.copy_to``: each rank's slice adds
a part of their gradient.  With ``count`` the loss is this rank's rows'
sum over ``count`` tokens (the global batch's, whose rows the data ranks
split), so the data ranks' losses, and gradients, add up to the global
mean (the mean itself where ``count`` is this rank's own token count).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding

__all__ = ["V_CHUNK", "chunked_cross_entropy", "cross_entropy_dense"]

V_CHUNK = 8192


def _softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap else x


def cross_entropy_dense(logits: torch.Tensor, labels: torch.Tensor,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Reference: full-logits CE.  logits (..., V), labels (...) int."""
    logits = _softcap(logits.to(torch.float32), softcap)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return (lse - lab).mean()


def _chunk(m, sexp, lab_logit, h2, wck, lab, start: int, softcap):
    """One vocab chunk of the streaming logsumexp and label gather."""
    logits = _softcap(h2 @ wck.to(torch.float32), softcap)  # (N, Vc)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    sexp = sexp * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
    loc = lab - start
    inside = (loc >= 0) & (loc < logits.shape[1])
    col = torch.arange(logits.shape[1], device=logits.device)
    onehot = col[None, :] == loc[:, None]
    got = torch.where(onehot, logits, 0.0).sum(dim=-1)
    return m_new, sexp, torch.where(inside, got, lab_logit)


def chunked_cross_entropy(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *,
                          softcap: Optional[float] = None, v_chunk: int = V_CHUNK,
                          vocab_axis=None, count: Optional[int] = None) -> torch.Tensor:
    """Streaming CE.  hidden (B, S, D); w (D, V) head matrix, or with
    ``vocab_axis`` (a ``sharding.Axis``) this rank's (D, V / m) slice;
    labels (B, S) over the whole vocabulary; ``count`` divides the sum in
    place of the mean (the module's note)."""
    b, s, d = hidden.shape
    if vocab_axis is not None:
        hidden = sharding.copy_to(hidden, vocab_axis)
    v = w.shape[1]
    lo = 0 if vocab_axis is None else vocab_axis.index * v
    h2 = hidden.reshape(b * s, d).to(torch.float32)
    lab = labels.reshape(b * s).to(torch.int64)
    v_chunk = min(v_chunk, v)
    n = b * s
    m = torch.full((n,), float("-inf"), dtype=torch.float32, device=hidden.device)
    sexp = torch.zeros((n,), dtype=torch.float32, device=hidden.device)
    lab_logit = torch.zeros((n,), dtype=torch.float32, device=hidden.device)
    for start in range(0, v, v_chunk):
        m, sexp, lab_logit = checkpoint(_chunk, m, sexp, lab_logit, h2, w[:, start:start + v_chunk],
                                        lab, lo + start, softcap, use_reentrant=False)
    lse = m + torch.log(sexp)
    if vocab_axis is not None:
        top = sharding.all_reduce_max(lse.detach(), vocab_axis)
        lse = top + torch.log(sharding.reduce_from(torch.exp(lse - top), vocab_axis))
        mine = (lab >= lo) & (lab < lo + v)
        lab_logit = sharding.reduce_from(torch.where(mine, lab_logit, 0.0), vocab_axis)
    per = lse - lab_logit
    return per.mean() if count is None or count == per.numel() else per.sum() / count
