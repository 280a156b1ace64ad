"""Plain PyTorch version of the sum-mode EmbeddingBag.

    out[b] = sum over l of table[min(ids[b, l], V - 1)]   for ids[b, l] > 0

It computes the Hopper kernel's contract, so the CPU path and the card's
comparison both use it.  The sum runs in f32 in slot order l = 0, 1, ...,
L - 1 and is rounded once to the table's type.  The order is fixed because
f32 addition is not associative: the kernel adds each bag's rows in that
same order, so the two agree bit for bit in f32 and in bf16, where a sum
over the whole (B, L, D) gather in another order could differ in the last
bit.  Ids of 0 or below are padding and add nothing; ids of V or more read
row V - 1, as the JAX package's ``ref.py`` clips them.
"""
from __future__ import annotations

import torch

DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(table: torch.Tensor, ids: torch.Tensor) -> None:
    """The contract on every device: table (V, D) f32 or bf16, ids (B, L)
    int32, and a table with rows when any id could be read.  Raises
    ValueError otherwise."""
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"want table (V, D) and ids (B, L), got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if table.dtype not in DTYPES:
        raise ValueError(f"table must be f32 or bf16, got {table.dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")
    if table.shape[0] == 0 and ids.numel():
        raise ValueError("cannot read bags from a table without rows")


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: (V, D); ids: (B, L) int32, ids <= 0 padding -> (B, D) in the
    table's type."""
    check_inputs(table, ids)
    B, L = ids.shape
    acc = torch.zeros((B, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    if ids.numel():
        safe = ids.clamp(0, table.shape[0] - 1).long()
        valid = (ids > 0).unsqueeze(-1)
        for slot in range(L):
            acc += torch.where(valid[:, slot], table[safe[:, slot]].float(),
                               0.0)
    return acc.to(table.dtype)
