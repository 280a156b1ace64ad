"""GNN substrate of the port: the JAX package's ``models/gnn/common.py`` in
torch.

Message passing is gather (edge source features) -> edge transform ->
``index_add_`` scatter over a padded, statically shaped edge list.  The
port's ``GraphBatch`` may also carry ``nbr``, the padded in-neighbour
table that the ``segment_matmul`` kernel reads; :func:`split_neighbors`
builds it from the edge list, no wider than a cap, with the edges past the
cap apart.  It adds no feature: a sum over ``nbr`` and the overflow equals
the edge list's ``scatter_sum`` up to f32 summation order.

Sharding: :func:`scatter_sum`, :func:`gather`, :func:`degree` and
:func:`graph_readout` take a :class:`~repro_torch.placement.ShardCtx`
(``sctx``).  Under it the node and edge arrays are DTensors whose rows
lie over every mesh axis (``sctx.rows_pl``, the reference's
``flat_shard``), senders and receivers hold global node ids, and each op
is an explicit region on the local shards (``sctx.local``), never
DTensor's default rules for ``index_select`` and ``index_add_``:
  * gather: the node values all-gathered, then this rank's edges read
    from them; its backward adds each edge's gradient into a full-N
    partial sum, reduce-scattered back to node rows;
  * scatter: this rank's edges added into a full-N partial sum, then
    reduce-scattered to node rows (GSPMD all-reduces there; a
    reduce-scatter moves half the bytes and leaves the rows where the
    node arrays live); its backward all-gathers the node gradient;
  * readout: this rank's (n_graphs, ...) partial sum, all-reduced.
A replicated table gathered by node rows (the species embeddings) takes
no all-gather; its gradient is a partial sum that the step all-reduces.
The models' forwards under a context run in ``ShardCtx.implicit()``, and
so do their backwards (``launch.steps`` does both).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...devices import seeded_generator, randn, resolve_device


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
    overflow: optional (senders (E_over,), hub_of (E_over,), hubs
        (n_hubs,)), the edges ``nbr`` leaves out (``split_neighbors``' cut
        past a cap): each one's sender, its receiver's index in ``hubs``
        and the receivers themselves
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
    overflow: Optional[tuple] = None

    @property
    def n_nodes(self) -> int:
        return int(self.node_mask.shape[0])


def _mask_rows(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.reshape((-1,) + (1,) * (vals.dim() - 1)), vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))


def scatter_sum(edge_vals, receivers, n_nodes, edge_mask=None, sctx=None):
    """(n_nodes, ...) sums of the (unmasked) edge rows into their
    receivers; under ``sctx`` node rows over every axis (see the
    module's docstring)."""
    if sctx is not None:
        rows = sctx.rows_pl
        args = (edge_vals, receivers) + (
            () if edge_mask is None else (edge_mask,))
        part = sctx.local(
            lambda v, r, *m: scatter_sum(v, r, n_nodes, *m),
            [sctx.partial_pl], [rows] * len(args))(*args)
        return part.redistribute(sctx.mesh, rows)
    if edge_mask is not None:
        edge_vals = _mask_rows(edge_vals, edge_mask)
    out = torch.zeros((n_nodes,) + tuple(edge_vals.shape[1:]),
                      dtype=edge_vals.dtype, device=edge_vals.device)
    return out.index_add_(0, receivers.long(), edge_vals)


def gather(node_vals, idx, sctx=None):
    """``node_vals[idx]``; under ``sctx`` ``idx`` (rows over every axis)
    holds global row ids of ``node_vals`` (node rows, or replicated)."""
    if sctx is not None:
        rows = sctx.rows_pl
        return sctx.local(lambda v, i: gather(v, i), [rows],
                          [sctx.replicated_pl, rows],
                          [sctx.partial_pl, rows])(node_vals, idx)
    return node_vals.index_select(0, idx.long())


def degree(receivers, n_nodes, edge_mask=None, sctx=None):
    ones = torch.ones_like(receivers, dtype=torch.float32)
    return scatter_sum(ones, receivers, n_nodes, edge_mask, sctx)


def graph_readout(node_vals, graph_ids, n_graphs, node_mask, op="sum",
                  sctx=None):
    """Per-graph sum (or mean) of the unmasked node rows.

    On the CPU the sum is ``scatter_sum``'s ``index_add_``, which adds the
    rows in order, as the reference's ``segment_sum`` does.  On CUDA
    tensors ``index_add_`` adds with atomics in an order that changes from
    run to run, so the sum is a one-hot (n_graphs, N) product instead: a
    fixed order, the same bits every run, and its gradient through the
    matmul.  (It follows the matmul settings, e.g. TF32, as every linear
    layer of the model does.)  Under ``sctx`` each rank sums its node
    rows and the partial sums are all-reduced: the result is
    replicated."""
    if sctx is not None:
        rows = sctx.rows_pl

        def region(fn, *args):
            part = sctx.local(fn, [sctx.partial_pl], [rows] * len(args))(
                *args)
            return part.redistribute(sctx.mesh, sctx.replicated_pl)

        s = region(lambda v, g, m: graph_readout(v, g, n_graphs, m),
                   node_vals, graph_ids, node_mask)
        if op == "sum":
            return s
        cnt = region(lambda m, g: scatter_sum(m.float(), g, n_graphs),
                     node_mask, graph_ids)
        return s / torch.clamp(cnt[:, None], min=1.0)
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
    p = {"w": randn((d_in, d_out), generator, dtype) / np.sqrt(d_in)}
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


class ParamTree(nn.Module):
    """A nested parameter dict (dicts, lists and tensors, as the
    reference's pytrees are laid out) as a module: each tensor becomes an
    ``nn.Parameter`` without a copy, each dict a ``ParamTree``, each list
    an ``nn.ModuleList``, so ``named_parameters()`` gives the tree's paths
    joined by dots ("layers.0.R0.l1.w").  ``tree[key]`` and ``key in
    tree`` read it as the dict it came from, so :func:`linear` and
    :func:`mlp2` take it as they take a dict."""

    def __init__(self, params):
        super().__init__()
        self._keys = tuple(params)
        for key, value in params.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(key, nn.Parameter(value))
            elif isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.add_module(key, nn.ModuleList(ParamTree(v)
                                                   for v in value))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key):
        return key in self._keys

    def keys(self):
        return self._keys


class GraphModel(ParamTree):
    """Base of the port's GCN, SchNet and MACE: a :class:`ParamTree` of
    the reference's parameter layout on one device.

    ``params`` is laid out as the model module's ``init_params`` returns
    it (or as ``repro_torch.convert`` carries it over from the JAX
    package); without it the parameters are drawn from a
    ``torch.Generator`` seeded with ``seed`` on the device.  The module
    takes the given tensors as its parameters without a copy (on their
    device), so training updates them in place.  It runs on CUDA unless
    ``device`` asks for the CPU, and raises where CUDA is missing.
    Subclasses set ``init`` (their ``init_params``) and ``depth``: the
    params key of the list of blocks and the config field it matches.
    """
    init = None
    depth = ("layers", "n_layers")

    def __init__(self, cfg, params=None, *, device=None, seed: int = 0):
        dev = resolve_device(device, type(self).__name__)
        if params is None:
            params = type(self).init(
                cfg, seeded_generator(dev, seed))
        key, field = self.depth
        if len(params[key]) != getattr(cfg, field):
            raise ValueError(f"{len(params[key])} {key} of parameters for a "
                             f"config of {getattr(cfg, field)}")
        super().__init__(params)
        self.cfg = cfg
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _check_device(self, t: torch.Tensor) -> None:
        if t.device != self.device:
            raise ValueError(f"batch on {t.device}, model on {self.device}")
