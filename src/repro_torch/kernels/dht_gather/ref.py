"""Plain PyTorch version of the cached gather (the DHT lookup's kernel).

It computes the kernel's whole contract, so the CPU path and the card's
comparison both use it: rows for a SORTED key batch, put back in the
caller's order, and the cache-hit count of adjacent duplicate valid keys.
"""
from __future__ import annotations

import torch


def dht_gather_ref(table: torch.Tensor, sorted_keys: torch.Tensor):
    """table: (V, D); sorted_keys: (Q,) int32 ascending, -1 = padding.

    Returns (out (Q, D), hits): padding rows are zeros, out-of-range keys
    read row V-1, and ``hits == n_valid - n_distinct_valid`` (0-d int64).
    """
    valid = sorted_keys >= 0
    safe = sorted_keys.clamp(0, table.shape[0] - 1).long()
    out = table[safe].masked_fill(~valid[:, None], 0)
    hits = ((sorted_keys[1:] == sorted_keys[:-1]) & valid[1:]).sum()
    return out, hits


def dht_gather_fused_ref(table: torch.Tensor, sorted_keys: torch.Tensor,
                         order: torch.Tensor | None):
    """The kernel's contract: :func:`dht_gather_ref`'s rows, with sorted
    row q written to row ``order[q]`` (``order`` the permutation
    ``torch.sort`` returned with the keys; None for the identity)."""
    out, hits = dht_gather_ref(table, sorted_keys)
    if order is not None:
        unsorted = torch.empty_like(out)
        unsorted[order] = out
        out = unsorted
    return out, hits
