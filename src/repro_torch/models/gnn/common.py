"""GNN substrate of the port: the JAX package's ``models/gnn/common.py`` in
torch.

Message passing is gather (edge source features) -> edge transform ->
``index_add_`` scatter over a padded, statically shaped edge list.  The
port's ``GraphBatch`` may also carry ``nbr``, the padded in-neighbour
table that the ``segment_matmul`` kernel reads; :func:`split_neighbors`
builds it from the edge list, no wider than a cap, with the edges past the
cap apart.  It adds no feature: a sum over ``nbr`` and the overflow equals
the edge list's ``scatter_sum`` up to f32 summation order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class GraphBatch:
    """Padded, statically shaped graph batch of torch tensors.

    senders/receivers: (E,) int32 (pad edges point at node N - 1, masked)
    node_feat: (N, F) float or None
    positions: (N, 3) float or None; species: (N,) int or None
    node_mask: (N,) bool; edge_mask: (E,) bool
    graph_ids: (N,) int32 (graph membership for readout); n_graphs: int
    labels: optional (N,) or (n_graphs,) targets
    nbr: optional (N, K) int32 in-neighbour table, -1 as padding: row n
        lists the senders of n's unmasked edges in edge order
    """
    senders: torch.Tensor
    receivers: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    graph_ids: torch.Tensor
    n_graphs: int
    node_feat: Optional[torch.Tensor] = None
    positions: Optional[torch.Tensor] = None
    species: Optional[torch.Tensor] = None
    labels: Optional[torch.Tensor] = None
    nbr: Optional[torch.Tensor] = None

    @property
    def n_nodes(self) -> int:
        return int(self.node_mask.shape[0])


def _mask_rows(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.reshape((-1,) + (1,) * (vals.dim() - 1)), vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))


def scatter_sum(edge_vals, receivers, n_nodes, edge_mask=None):
    if edge_mask is not None:
        edge_vals = _mask_rows(edge_vals, edge_mask)
    out = torch.zeros((n_nodes,) + tuple(edge_vals.shape[1:]),
                      dtype=edge_vals.dtype, device=edge_vals.device)
    return out.index_add_(0, receivers.long(), edge_vals)


def gather(node_vals, idx):
    return node_vals.index_select(0, idx.long())


def degree(receivers, n_nodes, edge_mask=None):
    ones = torch.ones(receivers.shape[0], dtype=torch.float32,
                      device=receivers.device)
    return scatter_sum(ones, receivers, n_nodes, edge_mask)


def graph_readout(node_vals, graph_ids, n_graphs, node_mask, op="sum"):
    """Per-graph sum (or mean) of the unmasked node rows.

    On the CPU the sum is ``scatter_sum``'s ``index_add_``, which adds the
    rows in order, as the reference's ``segment_sum`` does.  On CUDA
    tensors ``index_add_`` adds with atomics in an order that changes from
    run to run, so the sum is a one-hot (n_graphs, N) product instead: a
    fixed order, the same bits every run, and its gradient through the
    matmul.  (It follows the matmul settings, e.g. TF32, as every linear
    layer of the model does.)"""
    vals = _mask_rows(node_vals, node_mask)
    if vals.is_cuda:
        ids = torch.arange(n_graphs, device=vals.device)
        onehot = (graph_ids.long()[None, :] == ids[:, None]).to(vals.dtype)
        s = (onehot @ vals.reshape(vals.shape[0], -1)).reshape(
            (n_graphs,) + tuple(vals.shape[1:]))
    else:
        s = scatter_sum(vals, graph_ids, n_graphs)
    if op == "sum":
        return s
    cnt = scatter_sum(node_mask.float(), graph_ids, n_graphs)
    return s / torch.clamp(cnt[:, None], min=1.0)


def split_neighbors(senders, receivers, edge_mask, n_nodes,
                    cap: Optional[int] = None):
    """An edge list's in-neighbour table, at most ``cap`` slots a row, and
    the edges past the cap: (nbr (n_nodes, K) int32 with -1 as padding,
    overflow senders (E_over,), overflow receivers (E_over,)), K the
    largest in-degree capped at ``cap`` (at least 1).

    Row n holds the senders of the first K unmasked edges into n, in edge
    order (a stable sort on the receiver); the rest of n's edges come back
    as the overflow pair, sorted by receiver and in edge order within one.
    Without a cap the overflow is empty."""
    keep = edge_mask.bool()
    s, r = senders[keep].long(), receivers[keep].long()
    r_sorted, order = torch.sort(r, stable=True)
    s_sorted = s[order]
    counts = torch.bincount(r, minlength=n_nodes)
    K = int(counts.max()) if r.numel() else 0
    K = max(K if cap is None else min(K, cap), 1)
    start = torch.cumsum(counts, 0) - counts
    col = torch.arange(r.numel(), device=r.device) - start[r_sorted]
    fits = col < K
    nbr = torch.full((n_nodes, K), -1, dtype=torch.int32, device=r.device)
    nbr[r_sorted[fits], col[fits]] = s_sorted[fits].to(torch.int32)
    return nbr, s_sorted[~fits], r_sorted[~fits]


def padded_neighbors(senders, receivers, edge_mask, n_nodes) -> torch.Tensor:
    """The (n_nodes, K) int32 in-neighbour table of an edge list, -1 as
    padding, K the largest in-degree (at least 1): row n holds the senders
    of the unmasked edges into n, in edge order (a stable sort on the
    receiver)."""
    return split_neighbors(senders, receivers, edge_mask, n_nodes)[0]


def init_linear(generator: torch.Generator, d_in, d_out,
                dtype=torch.float32, bias=True):
    """{"w": (d_in, d_out) ~ N(0, 1/d_in), "b": zeros}, drawn from
    ``generator`` on its device (the reference's shapes and scales)."""
    dev = generator.device
    p = {"w": torch.randn((d_in, d_out), generator=generator, device=dev,
                          dtype=dtype) / np.sqrt(d_in)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return p


def linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_mlp2(generator: torch.Generator, d_in, d_hidden, d_out,
              dtype=torch.float32):
    return {"l1": init_linear(generator, d_in, d_hidden, dtype),
            "l2": init_linear(generator, d_hidden, d_out, dtype)}


def mlp2(p, x, act=F.silu):
    return linear(p["l2"], act(linear(p["l1"], x)))
