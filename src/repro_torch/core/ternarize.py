"""Ternarization (Algorithm 2, line 2): bound degrees by 3.

Every vertex v with deg(v) > 3 is replaced by a cycle of deg(v) dummy
vertices; the i-th incident edge of v attaches to the i-th cycle vertex.
Dummy cycle edges get weight "bottom" (strictly below the lightest real edge)
so they always enter the MSF first and never displace real MSF edges; they are
removed from the output (their edge id is -1).

Host-side numpy, array-equal to the JAX package's ``repro.core.ternarize``;
the per-edge and per-vertex Python loops of the reference are vectorized.
"""
from __future__ import annotations

import dataclasses

import numpy as np

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
