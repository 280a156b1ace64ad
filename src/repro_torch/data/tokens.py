"""Deterministic synthetic LM token pipeline.

Produces (batch, seq) int32 token batches with next-token labels.
The stream is a seeded markov-ish mixture so the loss is learnable (tests
assert loss decreases).  Host-side numpy; deterministic in (seed, step) so
any worker can regenerate any shard — the property that makes data restart
and straggler re-dispatch trivial (no data state in checkpoints beyond the
step counter).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def batch_at_step(cfg: TokenStreamConfig, step: int):
    """Returns (tokens (B, S), labels (B, S)), deterministic in
    (seed, step)."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    # structured stream: ascending runs + noise => learnable
    starts = rng.integers(0, V, (B, 1))
    ramps = (starts + np.arange(S + 1)) % V
    noise = rng.integers(0, V, (B, S + 1))
    take_noise = rng.random((B, S + 1)) < 0.1
    seq = np.where(take_noise, noise, ramps).astype(np.int32)
    return seq[:, :-1], seq[:, 1:]


def shard_of_batch(tokens, labels, shard: int, n_shards: int):
    """Static round-robin sharding of the global batch (straggler re-dispatch
    re-assigns shard indices, not data): rows shard, shard + n_shards,
    ..."""
    return tokens[shard::n_shards], labels[shard::n_shards]
