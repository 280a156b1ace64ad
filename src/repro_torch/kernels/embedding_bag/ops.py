"""``embedding_bag``: the sum-mode EmbeddingBag, (V, D) x (B, L) -> (B, D).

On a CUDA tensor it launches the Hopper kernel (``kernel.py``); on a CPU
tensor it runs the plain version (``ref.py``); on a ``meta`` tensor it
returns an empty output (no launch, no count).  There is no fallback from
one to the other.  The JAX package has no backward kernel and no path of
either package differentiates it, so neither does the port: a table that
would need a gradient raises.
"""
from __future__ import annotations

import torch

from .kernel import embedding_bag_cuda
from .ref import check_inputs, embedding_bag_ref


def embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Sum each bag's valid rows: table (V, D) f32 or bf16, ids (B, L)
    int32 with ids <= 0 as padding and ids >= V reading row V - 1; (B, D)
    in the table's type, summed in f32 in slot order.

    ``embedding_bag.launches`` counts kernel launches (CUDA tensors, B and
    D nonzero); ``embedding_bag.meta_flops`` the additions, B·L·D, of the
    calls answered on ``meta``.
    """
    check_inputs(table, ids)
    if ids.device != table.device:
        raise ValueError("table and ids must be on the same device")
    if torch.is_grad_enabled() and table.requires_grad:
        raise ValueError("embedding_bag has no backward: pass a table that "
                         "does not require grad, or call it under "
                         "torch.no_grad()")
    if table.is_cuda:
        out = embedding_bag_cuda(table, ids)
        if ids.shape[0] and table.shape[1]:
            embedding_bag.launches += 1
        return out
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids)
    if table.device.type == "meta":
        embedding_bag.meta_flops += ids.numel() * table.shape[1]
        return torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                           device="meta")
    raise ValueError(f"embedding_bag runs on CUDA, CPU or meta tensors, got "
                     f"{table.device}")


embedding_bag.launches = 0
embedding_bag.meta_flops = 0
