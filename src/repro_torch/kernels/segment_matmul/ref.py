"""Plain PyTorch version of ``segment_matmul``: padded-neighbour
aggregation, then the weight transform.

    out[n] = (sum_k x[nbr[n, k]]) @ W      with nbr == -1 entries masked

This is the GNN message-passing hot loop in padded-CSR form (the form the
sampled blocks use).  It computes the Hopper kernel's contract, so the CPU
path and the card's comparison both use it: the neighbour rows are summed
in f32 in slot order (k = 0, 1, ...), the sum is multiplied by W in f32,
and the product is rounded once to ``x``'s type.  Indices past the last row
read the last row, as the JAX package's ``ref.py`` clips them.
"""
from __future__ import annotations

import torch


def check_inputs(x: torch.Tensor, nbr: torch.Tensor,
                 w: torch.Tensor) -> None:
    """The contract on every device: x (N, D), nbr (M, K) int32, w (D, F),
    and an x with rows when nbr has any.  Raises ValueError otherwise."""
    if x.dim() != 2 or nbr.dim() != 2 or w.dim() != 2:
        raise ValueError(f"want x (N, D), nbr (M, K) and w (D, F), got "
                         f"{tuple(x.shape)}, {tuple(nbr.shape)}, "
                         f"{tuple(w.shape)}")
    if nbr.dtype != torch.int32:
        raise ValueError(f"nbr must be int32, got {nbr.dtype}")
    if w.shape[0] != x.shape[1]:
        raise ValueError(f"x has {x.shape[1]} columns, w {w.shape[0]} rows")
    if x.shape[0] == 0 and nbr.shape[0]:
        raise ValueError("cannot gather from an x without rows")


def neighbor_sum(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """The f32 (M, D) sum of each row's valid neighbour rows of ``x``, one
    slot after another (zeros for a row without one)."""
    agg = torch.zeros((nbr.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    if x.shape[0] == 0:
        return agg
    safe = nbr.clamp(0, x.shape[0] - 1).long()
    valid = (nbr >= 0).unsqueeze(-1)
    for k in range(nbr.shape[1]):
        agg += torch.where(valid[:, k], x[safe[:, k]].float(), 0.0)
    return agg


def segment_matmul_ref(x: torch.Tensor, nbr: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """x: (N, D); nbr: (M, K) int32 (-1 pad); w: (D, F) -> (M, F) in x's
    type."""
    check_inputs(x, nbr, w)
    return (neighbor_sum(x, nbr) @ w.float()).to(x.dtype)


def product_limit(agg: torch.Tensor, w: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """A per-element bound on the distance between two versions of
    ``segment_matmul`` that share the f32 neighbour sum ``agg`` (M, D) and
    differ only in the order of the D-term product with ``w``.

    Each f32 order is within D 2^-24 sum_d |agg w| of the exact product,
    so two orders are within twice that (and a little more for the f32
    rounding of the bound itself); rounding both to bf16 may put them one
    bf16 unit (2^-7 of the value) further apart.
    """
    D = max(agg.shape[1], 1)
    s = agg.abs() @ w.float().abs()
    limit = (2 * D * 2 ** -24 * 1.01) * s
    if dtype == torch.bfloat16:
        limit = limit + 2 ** -7 * (agg @ w.float()).abs()
    return limit
