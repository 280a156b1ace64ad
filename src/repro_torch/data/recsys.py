"""Synthetic sequential-recommendation data (SASRec shapes): the JAX
package's ``data/recsys.py``, in numpy, array-equal to it for every seed
and step."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RecStreamConfig:
    n_items: int
    seq_len: int
    batch: int
    seed: int = 0


def batch_at_step(cfg: RecStreamConfig, step: int):
    """Returns (item_seq, pos_items, neg_items), each (B, S) int32 numpy.
    Item 0 is padding.  Sequences follow seeded item-cluster dynamics so
    the BPR loss is learnable."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    B, S, V = cfg.batch, cfg.seq_len, cfg.n_items
    cluster = rng.integers(1, max(V // 64, 2), (B, 1))
    walk = (cluster * 64 + rng.integers(0, 64, (B, S + 1))) % (V - 1) + 1
    seq = walk[:, :-1].astype(np.int32)
    pos = walk[:, 1:].astype(np.int32)
    neg = rng.integers(1, V, (B, S)).astype(np.int32)
    # pad a random prefix (variable-length histories)
    plen = rng.integers(0, S // 2, (B, 1))
    mask = np.arange(S)[None, :] < plen
    seq = np.where(mask, 0, seq)
    pos = np.where(mask, 0, pos)
    return seq, pos, neg
