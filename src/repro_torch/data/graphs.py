"""Graph dataset builders: padded ``GraphBatch`` construction and the
neighbour sampler; the JAX package's ``data/graphs.py`` with torch tensors.

The same seed gives the same arrays as the reference:
  * cora_like       — full_graph_sm (node classification)
  * products_like   — ogb_products (full-batch large; scaled down)
  * molecules       — batched small radius graphs with positions/species
  * NeighborSampler — layer-wise fanout sampling (minibatch_lg), CSR
                      sampling in numpy on the host

Two changes in PyTorch idiom keep the values: ``sample_block`` also fills
the block's padded in-neighbour table ``nbr`` (the ``segment_matmul``
kernel's input), and given a feature table that lives on the card it
gathers the block's rows there, where the reference gathers in numpy and
copies the block's features to the device every step.  Batches are built
on CUDA unless ``device`` asks for the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..devices import resolve_device
from ..graph import generators as gen
from ..graph.coo import UGraph
from ..models.gnn.common import GraphBatch


def _to_batch(g: UGraph, node_feat=None, positions=None, species=None,
              labels=None, graph_ids=None, n_graphs=1,
              pad_nodes: Optional[int] = None,
              pad_edges: Optional[int] = None, device=None) -> GraphBatch:
    dev = resolve_device(device, "graph batches")
    s, r, _, _ = g.symmetric()
    n, e = g.n, len(s)
    pn = pad_nodes or n
    pe = pad_edges or e
    if pn < n or pe < e:
        raise ValueError(f"padding ({pn}, {pe}) below the graph's ({n}, {e})")
    senders = np.full(pe, pn - 1, np.int32); senders[:e] = s
    receivers = np.full(pe, pn - 1, np.int32); receivers[:e] = r
    edge_mask = np.zeros(pe, bool); edge_mask[:e] = True
    node_mask = np.zeros(pn, bool); node_mask[:n] = True

    def t(x):
        return None if x is None else torch.from_numpy(np.asarray(x)).to(dev)

    def pad2(x, fill=0.0):
        if x is None:
            return None
        out = np.full((pn,) + x.shape[1:], fill, x.dtype)
        out[:n] = x
        return t(out)

    gid = np.zeros(pn, np.int32)
    if graph_ids is not None:
        gid[:n] = graph_ids
    lab = None
    if labels is not None:
        lab = pad2(labels) if labels.shape[0] == n else t(labels)
    return GraphBatch(
        senders=t(senders), receivers=t(receivers), node_mask=t(node_mask),
        edge_mask=t(edge_mask), graph_ids=t(gid), n_graphs=n_graphs,
        node_feat=pad2(node_feat), positions=pad2(positions),
        species=pad2(species), labels=lab)


def cora_like(n_nodes=2708, avg_deg=4.0, d_feat=1433, n_classes=7, seed=0,
              device=None):
    g = gen.erdos_renyi(n_nodes, avg_deg, seed=seed)
    rng = np.random.default_rng(seed)
    feat = (rng.random((g.n, d_feat)) < 0.01).astype(np.float32)
    labels = rng.integers(0, n_classes, g.n).astype(np.int32)
    return _to_batch(g, node_feat=feat, labels=labels, device=device)


def products_like(n_nodes=10000, avg_deg=8.0, d_feat=100, n_classes=47,
                  seed=0, device=None):
    g = gen.rmat(int(np.ceil(np.log2(n_nodes))), avg_deg, seed=seed)
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((g.n, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, g.n).astype(np.int32)
    return _to_batch(g, node_feat=feat, labels=labels, device=device)


def molecules(n_graphs=128, n_atoms=30, seed=0, d_feat: int = 0,
              device=None):
    """Batch of small radius graphs with positions + species (+ optional
    one-hot-ish features for GCN/GIN)."""
    parts, pos_all, sp_all, gids = [], [], [], []
    off = 0
    rng = np.random.default_rng(seed)
    for i in range(n_graphs):
        g, pos, sp = gen.random_geometric(n_atoms, 1.6, seed=seed * 1000 + i)
        parts.append(g.edges + off)
        pos_all.append(pos); sp_all.append(sp)
        gids.append(np.full(n_atoms, i, np.int32))
        off += n_atoms
    g = UGraph(off, np.concatenate(parts))
    pos = np.concatenate(pos_all); sp = np.concatenate(sp_all)
    gid = np.concatenate(gids)
    energies = rng.standard_normal(n_graphs).astype(np.float32)
    feat = None
    if d_feat:
        width = max(d_feat, 8)
        feat = np.eye(width, dtype=np.float32)[sp % width][:, :d_feat]
    return _to_batch(g, node_feat=feat, positions=pos, species=sp,
                     labels=energies, graph_ids=gid, n_graphs=n_graphs,
                     device=device)


class NeighborSampler:
    """Layer-wise uniform fanout sampler over a CSR graph (GraphSAGE-style).

    Sampling runs in numpy on the host, drawing the reference's random
    numbers in the reference's order; the block is a ``GraphBatch`` on
    ``device`` (CUDA unless the caller asks for the CPU) with the static
    shapes of the minibatch_lg spec.
    """

    def __init__(self, g: UGraph, fanout: Tuple[int, ...], seed: int = 0,
                 device=None):
        self.indptr, self.indices, _, _ = g.csr()
        self.fanout = tuple(fanout)
        self.rng = np.random.default_rng(seed)
        self.n = g.n
        self.device = resolve_device(device, "graph batches")

    def sample(self, seeds: np.ndarray):
        """The host half of :meth:`sample_block`: (nodes (N,) int64 global
        ids, senders (E,) int32, receivers (E,) int32, nbr (N, K) int32)
        in block-local ids, K = max(fanout).  Each hop's targets take
        exactly f sampled neighbours (with replacement; a vertex without
        one takes itself), so their nbr rows hold f valid slots; the last
        hop's rows hold none."""
        nodes = [seeds.astype(np.int64)]
        edges_s, edges_r, hops = [], [], []
        frontier = seeds.astype(np.int64)
        base = 0
        for f in self.fanout:
            deg = self.indptr[frontier + 1] - self.indptr[frontier]
            # uniform sample with replacement, padded to exactly f per node
            r = self.rng.integers(0, np.maximum(deg, 1)[:, None],
                                  (len(frontier), f))
            idx = self.indptr[frontier][:, None] + r
            nbrs = self.indices[np.minimum(idx, self.indptr[frontier][:, None]
                                           + np.maximum(deg - 1, 0)[:, None])]
            nbrs = np.where(deg[:, None] > 0, nbrs, frontier[:, None])
            new = nbrs.reshape(-1)
            # local ids: targets are at [base, base + len(frontier)); new
            # nodes appended after the current total
            total = sum(len(x) for x in nodes)
            src_local = total + np.arange(len(new))
            dst_local = base + np.repeat(np.arange(len(frontier)), f)
            edges_s.append(src_local); edges_r.append(dst_local)
            hops.append((base, len(frontier), f, src_local))
            nodes.append(new)
            base = total
            frontier = new
        all_nodes = np.concatenate(nodes)
        s = np.concatenate(edges_s).astype(np.int32)
        r = np.concatenate(edges_r).astype(np.int32)
        nbr = np.full((len(all_nodes), max(self.fanout, default=1)), -1,
                      np.int32)
        for base, n_targets, f, src_local in hops:
            nbr[base:base + n_targets, :f] = src_local.reshape(n_targets, f)
        return all_nodes, s, r, nbr

    def to_block(self, sample, node_feat, labels) -> GraphBatch:
        """The device half of :meth:`sample_block`: the block's arrays on
        the sampler's device, and its rows of ``node_feat`` and
        ``labels``, each gathered where it lives (a torch tensor on its
        device, a numpy array on the host) and moved to the device."""
        all_nodes, s, r, nbr = sample
        dev = self.device

        def rows(table):
            if table is None:
                return None
            if isinstance(table, torch.Tensor):
                idx = torch.from_numpy(all_nodes).to(table.device)
                return table.index_select(0, idx).to(dev)
            return torch.from_numpy(np.asarray(table)[all_nodes]).to(dev)

        N, E = len(all_nodes), len(s)
        return GraphBatch(
            senders=torch.from_numpy(s).to(dev),
            receivers=torch.from_numpy(r).to(dev),
            node_mask=torch.ones(N, dtype=torch.bool, device=dev),
            edge_mask=torch.ones(E, dtype=torch.bool, device=dev),
            graph_ids=torch.zeros(N, dtype=torch.int32, device=dev),
            n_graphs=1, node_feat=rows(node_feat), labels=rows(labels),
            nbr=torch.from_numpy(nbr).to(dev))

    def sample_block(self, seeds: np.ndarray, node_feat, labels
                     ) -> GraphBatch:
        """A ``GraphBatch`` whose first len(seeds) nodes are the seeds;
        edges point sampled neighbour -> target (message direction)."""
        return self.to_block(self.sample(seeds), node_feat, labels)
