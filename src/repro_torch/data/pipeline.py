"""Deterministic synthetic data pipeline with sharded host loading.

Real multi-pod deployments feed each host only its slice of the global
batch; the loader here follows that contract: ``host_batch_slice`` returns
the (process_index, process_count)-dependent row range, and every batch is
generated *counter-based* (seed = hash(seed, step)) so that a restart at
step k reproduces exactly the batch the failed run would have seen — a
requirement for deterministic recovery (runtime/fault.py).

The synthetic distribution is a Zipf-like unigram mix with a shifted-copy
structure (labels are next-token), giving a learnable non-uniform stream
whose loss visibly decreases within a few hundred steps (examples/).

The port's own copy of ``repro/data/pipeline.py`` (numpy only, so its
batches are bit-equal to the reference's).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "host_batch_slice"]


def host_batch_slice(global_batch: int, process_index: int, process_count: int) -> slice:
    if global_batch % process_count != 0:
        raise ValueError(f"global_batch {global_batch} not divisible by hosts {process_count}")
    per = global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2  # unigram skew
    copy_period: int = 64  # structure: token[t] depends on token[t - period]


class SyntheticLM:
    """Counter-based synthetic LM stream.

    ``batch(step)`` is a pure function of (config, step): restartable and
    identical across hosts (each host then slices its rows).
    """

    def __init__(self, cfg: DataConfig, process_index: int = 0, process_count: int = 1):
        self.cfg = cfg
        self._slice = host_batch_slice(cfg.global_batch, process_index, process_count)
        # fixed Zipf-ish unigram distribution over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(key=cfg.seed, counter=step))
        tok = rng.choice(
            cfg.vocab_size, size=(cfg.global_batch, cfg.seq_len + 1), p=self._p
        ).astype(np.int32)
        # inject copy structure: with p=0.5 repeat the token copy_period back
        if cfg.copy_period and cfg.seq_len + 1 > cfg.copy_period:
            mask = rng.random((cfg.global_batch, cfg.seq_len + 1)) < 0.5
            mask[:, : cfg.copy_period] = False
            shifted = np.roll(tok, cfg.copy_period, axis=1)
            tok = np.where(mask, shifted, tok)
        tok = tok[self._slice]
        return {
            "tokens": tok[:, :-1],
            "labels": tok[:, 1:],
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
