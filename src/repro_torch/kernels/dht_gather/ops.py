"""``dht_gather``: the cached gather behind the DHT lookup.

On a CUDA tensor it launches the Hopper kernel (``kernel.py``); on a CPU
tensor it runs the plain version (``ref.py``); on a ``meta`` tensor it
returns empty outputs of the right shapes (the dry-run's branch: no
launch, no count).  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from .kernel import dht_gather_cuda
from .ref import dht_gather_fused_ref


def dht_gather(table: torch.Tensor, keys: torch.Tensor,
               presorted: bool = False):
    """Gather table rows for a key batch with the caching optimization.

    ``table`` is (V, D); ``keys`` (Q,) int32, any order unless
    ``presorted``, with negative entries treated as invalid (zero rows).
    The batch is sorted (stable) and gathered in sorted order, each row
    written straight to its key's place in the caller's order.  Returns
    (out (Q, D), cache_hits): ``cache_hits`` counts adjacent duplicate
    *valid* keys in sorted order, i.e. exactly ``n_valid -
    n_distinct_valid``, as a 0-d integer tensor.

    ``dht_gather.launches`` counts kernel launches (CUDA tensors, Q > 0);
    ``dht_gather.meta_bytes`` the bytes it reads in the calls answered on
    ``meta``: the sorted keys, their order and a row a key (its output
    is the allocation a counter sees).  A gather does no arithmetic: its
    ``meta_flops`` stays 0.  Inside a sharded region (``core.dht.
    dedup_gather``) ``table`` is this rank's slice, so both count the
    local shard.
    """
    if table.dim() != 2:
        raise ValueError(
            f"table must be (V, D), got shape {tuple(table.shape)}")
    if keys.dim() != 1 or keys.dtype != torch.int32:
        raise ValueError("keys must be a (Q,) int32 tensor")
    if keys.device != table.device:
        raise ValueError("table and keys must be on the same device")
    if presorted:
        sk, order = keys, None
    else:
        sk, order = torch.sort(keys, stable=True)
    if table.is_cuda:
        out, hits = dht_gather_cuda(table, sk, order)
        if sk.numel():
            dht_gather.launches += 1
        return out, hits
    if table.device.type == "cpu":
        return dht_gather_fused_ref(table, sk, order)
    if table.device.type == "meta":
        Q = keys.shape[0]
        dht_gather.meta_bytes += Q * (keys.itemsize + (
            0 if order is None else order.itemsize)
            + table.shape[1] * table.itemsize)
        return (torch.empty((keys.shape[0], table.shape[1]),
                            dtype=table.dtype, device="meta"),
                torch.empty((), dtype=torch.int64, device="meta"))
    raise ValueError(f"dht_gather runs on CUDA, CPU or meta tensors, got "
                     f"{table.device}")


dht_gather.launches = 0
dht_gather.meta_flops = 0
dht_gather.meta_bytes = 0
