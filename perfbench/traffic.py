"""The one generator of the benchmark's traffic, driven by a mix's data file
(``perfbench/traffic/<mix>.json``): token ids, training batches, the first
tokens of decode rows and the KV cache they start from, drawn on the
device from the run's seed.  Every seed gets the same sizes; only the
values differ."""
from __future__ import annotations

import torch

from .weights import generator


def token_ids(spec: dict, shape, vocab: int, gen: torch.Generator, device
              ) -> torch.Tensor:
    """int64 ids of ``shape`` drawn as ``spec`` says: ``{"dist": "zipf",
    "s": s}``, id r - 1 with probability proportional to r^-s (the
    vocabulary's ids in rank order), or ``{"dist": "uniform"}``."""
    if spec["dist"] == "uniform":
        return torch.randint(vocab, tuple(shape), generator=gen,
                             device=device)
    if spec["dist"] != "zipf":
        raise ValueError(f"unknown token distribution {spec['dist']!r}")
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** -float(spec["s"]), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(tuple(shape), dtype=torch.float64, generator=gen,
                   device=device)
    return torch.searchsorted(cdf, u).clamp_(max=vocab - 1)


def train_batches(mix: dict, vocab: int, seed: int, device):
    """(tokens, labels), each (pool_steps, B, S) int64: step i trains on
    row b's ``tokens[i, b]`` to predict ``labels[i, b]``, the same draw
    shifted by one; every row of the pool is drawn afresh."""
    B, S = mix["batch"], mix["seq_len"]
    seq = token_ids(mix["tokens"], (mix["pool_steps"], B, S + 1), vocab,
                    generator(device, seed, "tokens"), device)
    return seq[..., :-1].contiguous(), seq[..., 1:].contiguous()


def decode_start(mix: dict, config: dict, seed: int, dtype, device):
    """(first tokens (B,), cache {"k", "v": (L, B, S, Hkv, hd) in ``dtype``,
    "length": (B,) int32 S}): every slot of the ring filled, slot j holding
    position j, with keys and values drawn normal (the scale of keys and
    values that RMSNorm'd projections give), one draw a layer each."""
    B, S = mix["batch"], mix["cache_len"]
    d, H = config["hidden_size"], config["num_attention_heads"]
    Hkv, hd = config["num_key_value_heads"], config.get("head_dim") or d // H
    L = config["num_hidden_layers"]
    first = token_ids(mix["tokens"], (B,), config["vocab_size"],
                      generator(device, seed, "first"), device)
    k = torch.empty((L, B, S, Hkv, hd), dtype=dtype, device=device)
    v = torch.empty_like(k)
    for i in range(L):
        k[i].normal_(generator=generator(device, seed, "cache_k", i))
        v[i].normal_(generator=generator(device, seed, "cache_v", i))
    length = torch.full((B,), S, dtype=torch.int32, device=device)
    return first, {"k": k, "v": v, "length": length}

