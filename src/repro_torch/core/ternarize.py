"""Ternarization (Algorithm 2, line 2): bound degrees by 3.

Every vertex v with deg(v) > 3 is replaced by a cycle of deg(v) dummy
vertices; the i-th incident edge of v attaches to the i-th cycle vertex.
Dummy cycle edges get weight "bottom" (strictly below the lightest real edge)
so they always enter the MSF first and never displace real MSF edges; they are
removed from the output (their edge id is -1).

Host-side numpy, array-equal to the JAX package's ``repro.core.ternarize``;
the per-edge and per-vertex Python loops of the reference are vectorized.

``ternarize_batch`` is the bucketable variant the ``solve_many`` adapters
use: it ternarizes every graph of a shape bucket and pads the results to
shared pow-2 ``(nt_bucket, mt_bucket)`` shapes with masked lanes, following
``repro_torch.graph.batching``'s padding conventions.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from ..graph.batching import next_pow2
from ..graph.coo import UGraph


@dataclasses.dataclass
class TernGraph:
    g: UGraph                 # ternarized graph (weights include dummy edges)
    orig_eid: np.ndarray      # (m_tern,) original edge id, -1 for dummy edges
    node_of: np.ndarray       # (n_tern,) original vertex of each tern vertex
    n_orig: int
    m_orig: int


def ternarize(g: UGraph) -> TernGraph:
    if g.weights is None:
        raise ValueError("ternarize expects a weighted graph")
    n, m = g.n, g.m
    deg = g.degrees()
    slots = np.maximum(deg, 1)
    expand = deg > 3
    n_slots = np.where(expand, slots, 1).astype(np.int64)
    offset = np.zeros(n + 1, np.int64)
    np.cumsum(n_slots, out=offset[1:])
    n_tern = int(offset[-1])

    # position of each directed edge inside its source's adjacency list
    indptr, indices, w, eid = g.csr()
    pos_in_adj = np.arange(len(indices), dtype=np.int64) - np.repeat(
        indptr[:-1], np.diff(indptr))
    # each undirected eid appears exactly twice in the directed view: its
    # earlier CSR position gives slot_u, the later one slot_v
    by_eid = np.argsort(eid, kind="stable").reshape(m, 2)
    slot_u = pos_in_adj[by_eid[:, 0]]
    slot_v = pos_in_adj[by_eid[:, 1]]

    u, v = g.edges[:, 0].astype(np.int64), g.edges[:, 1].astype(np.int64)
    nu = offset[u] + np.where(expand[u], slot_u, 0)
    nv = offset[v] + np.where(expand[v], slot_v, 0)
    real_edges = np.stack([nu, nv], axis=1)

    # dummy cycle edges for expanded vertices
    exp_ids = np.where(expand)[0]
    exp_deg = deg[exp_ids]
    owner = np.repeat(exp_ids, exp_deg)
    starts = np.zeros(len(exp_ids), np.int64)
    np.cumsum(exp_deg[:-1], out=starts[1:])
    local = np.arange(len(owner), dtype=np.int64) - np.repeat(starts, exp_deg)
    base = offset[owner]
    dummy_edges = np.stack(
        [base + local, base + (local + 1) % deg[owner]], axis=1)

    lightest = float(g.weights.min()) if m else 0.0
    bot = lightest - 1.0
    k = dummy_edges.shape[0]
    # distinct, all < lightest
    dummy_w = bot - np.arange(k, dtype=np.float32) / max(k, 1)

    edges = np.concatenate([real_edges, dummy_edges]).astype(np.int32)
    weights = np.concatenate([g.weights, dummy_w]).astype(np.float32)
    orig = np.concatenate([np.arange(m, dtype=np.int32),
                           np.full(k, -1, np.int32)])

    node_of = np.repeat(np.arange(n, dtype=np.int32), n_slots)
    tg = UGraph(n_tern, edges, weights)
    return TernGraph(tg, orig, node_of, n, m)


@dataclasses.dataclass
class TernBatch:
    """One shape bucket of ternarized graphs, padded and stacked.

    Padding conventions (mirroring ``repro_torch.graph.batching``):

      * ``nbr``/``nbe`` pad with ``-1`` and ``nbw`` with ``+inf`` — a padded
        tern vertex looks exhausted to truncated Prim on its first frontier
        pop (1 query, case 2), which the adapters mask out of ``q_sum``;
      * ``edges`` pad with ``(0, 0)`` and ``edge_mask`` False, so the
        contraction invalidates them before they can join a component;
      * ``orig_eid`` pads with ``-1`` (indistinguishable from dummy cycle
        edges, which are filtered the same way);
      * real tern vertices / edges occupy the prefix of every row, so
        per-lane slices ``[:n_tern[b]]`` / ``[:m_tern[b]]`` recover the
        sequential arrays exactly.
    """

    terns: List[TernGraph]   # per-graph host ternarizations (orig_eid maps)
    nt_bucket: int
    mt_bucket: int
    n_tern: np.ndarray       # (B,) int64 real tern vertex counts
    m_tern: np.ndarray       # (B,) int64 real tern edge counts
    nbr: np.ndarray          # (B, nt_bucket, 3) int32, -1 pad
    nbw: np.ndarray          # (B, nt_bucket, 3) f32, +inf pad
    nbe: np.ndarray          # (B, nt_bucket, 3) int32, -1 pad
    edges: np.ndarray        # (B, mt_bucket, 2) int32, (0, 0) pad
    weights: np.ndarray      # (B, mt_bucket) f32, +inf pad
    orig_eid: np.ndarray     # (B, mt_bucket) int32, -1 pad
    edge_mask: np.ndarray    # (B, mt_bucket) bool
    node_mask: np.ndarray    # (B, nt_bucket) bool

    def __len__(self) -> int:
        return len(self.terns)


def ternarize_batch(graphs: Sequence[UGraph]) -> TernBatch:
    """Ternarize a bucket of graphs into one padded :class:`TernBatch`.

    The bucket shape is the next power of two over the largest ternarized
    vertex/edge count in the batch, so one cached bucket solver serves
    every occupant (and recurs across fleets whose ternarizations land in
    the same bucket)."""
    terns = [ternarize(g) for g in graphs]
    B = len(terns)
    nts = np.array([t.g.n for t in terns], np.int64)
    mts = np.array([t.g.m for t in terns], np.int64)
    ntb = next_pow2(int(nts.max()) if B else 1)
    mtb = next_pow2(int(mts.max()) if B else 1)
    nbr = np.full((B, ntb, 3), -1, np.int32)
    nbw = np.full((B, ntb, 3), np.inf, np.float32)
    nbe = np.full((B, ntb, 3), -1, np.int32)
    edges = np.zeros((B, mtb, 2), np.int32)
    weights = np.full((B, mtb), np.inf, np.float32)
    orig_eid = np.full((B, mtb), -1, np.int32)
    edge_mask = np.zeros((B, mtb), bool)
    node_mask = np.zeros((B, ntb), bool)
    for b, t in enumerate(terns):
        nt, mt = t.g.n, t.g.m
        bn, bw, be = t.g.padded_adj(3)
        nbr[b, :nt] = bn
        nbw[b, :nt] = bw
        nbe[b, :nt] = be
        edges[b, :mt] = t.g.edges
        weights[b, :mt] = t.g.weights
        orig_eid[b, :mt] = t.orig_eid
        edge_mask[b, :mt] = True
        node_mask[b, :nt] = True
    return TernBatch(terns=terns, nt_bucket=ntb, mt_bucket=mtb,
                     n_tern=nts, m_tern=mts, nbr=nbr, nbw=nbw, nbe=nbe,
                     edges=edges, weights=weights, orig_eid=orig_eid,
                     edge_mask=edge_mask, node_mask=node_mask)
