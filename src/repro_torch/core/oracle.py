"""Sequential numpy oracles — ground truth for the port's AMPC solvers.

A copy of the JAX package's ``repro.core.oracle`` (the parts the port's
problems need): random-greedy MIS and maximal matching are uniquely
determined by the rank permutation, the MSF is unique when weights are
distinct, connected components are unique.
"""
from __future__ import annotations

import numpy as np

from ..graph.coo import UGraph


class UnionFind:
    def __init__(self, n: int):
        self.p = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        root = x
        while self.p[root] != root:
            root = self.p[root]
        while self.p[x] != root:
            self.p[x], x = root, self.p[x]
        return root

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.p[ra] = rb
        return True


def connected_components(g: UGraph) -> np.ndarray:
    """Label array (n,) — min vertex id in each component."""
    uf = UnionFind(g.n)
    for u, v in g.edges:
        uf.union(int(u), int(v))
    roots = np.array([uf.find(i) for i in range(g.n)], np.int64)
    mins = np.full(g.n, g.n, np.int64)
    np.minimum.at(mins, roots, np.arange(g.n))
    return mins[roots]


def num_components(g: UGraph) -> int:
    return len(np.unique(connected_components(g)))


def kruskal_msf(g: UGraph):
    """Return (edge_index_mask, total_weight). Unique if weights distinct."""
    if g.weights is None:
        raise ValueError("kruskal_msf needs a weighted graph")
    order = np.argsort(g.weights, kind="stable")
    uf = UnionFind(g.n)
    mask = np.zeros(g.m, bool)
    total = 0.0
    for ei in order:
        u, v = g.edges[ei]
        if uf.union(int(u), int(v)):
            mask[ei] = True
            total += float(g.weights[ei])
    return mask, total


def greedy_mis(g: UGraph, rank: np.ndarray) -> np.ndarray:
    """Lexicographically-first MIS over the vertex rank permutation.

    Returns boolean (n,) membership. rank: (n,) distinct floats/ints.
    """
    order = np.argsort(rank, kind="stable")
    in_mis = np.zeros(g.n, bool)
    blocked = np.zeros(g.n, bool)
    indptr, indices, _, _ = g.csr()
    for v in order:
        if not blocked[v]:
            in_mis[v] = True
            blocked[indices[indptr[v]:indptr[v + 1]]] = True
            blocked[v] = True
    return in_mis


def greedy_mm(g: UGraph, edge_rank: np.ndarray) -> np.ndarray:
    """Random-greedy maximal matching by edge rank. Returns bool (m,).

    The reference's loop over the edges in rank order, on Python lists."""
    order = np.argsort(edge_rank, kind="stable")
    eu = g.edges[order, 0].tolist()
    ev = g.edges[order, 1].tolist()
    matched = bytearray(g.n)
    taken = []
    for k, (u, v) in enumerate(zip(eu, ev)):
        if not matched[u] and not matched[v]:
            taken.append(k)
            matched[u] = matched[v] = 1
    in_mm = np.zeros(g.m, bool)
    in_mm[order[np.asarray(taken, np.int64)]] = True
    return in_mm


def is_maximal_matching(g: UGraph, in_mm: np.ndarray) -> bool:
    matched = np.zeros(g.n, bool)
    for ei in np.where(in_mm)[0]:
        u, v = g.edges[ei]
        if matched[u] or matched[v]:
            return False  # not a matching
        matched[u] = matched[v] = True
    for u, v in g.edges:
        if not matched[u] and not matched[v]:
            return False  # not maximal
    return True


def is_mis(g: UGraph, in_set: np.ndarray) -> bool:
    """Independent (no edge inside the set) and maximal (every vertex
    outside the set has a neighbour inside it)."""
    u, v = g.edges[:, 0], g.edges[:, 1]
    if (in_set[u] & in_set[v] & (u != v)).any():
        return False
    covered = in_set.copy()
    covered[u[in_set[v]]] = True
    covered[v[in_set[u]]] = True
    return bool(covered.all())


def yoshida_mis_queries(g: UGraph, rank: np.ndarray) -> int:
    """Total query count of the Yoshida et al. recursive MIS process
    (run independently from every vertex, no memoization): the quantity the
    paper's caching optimization reduces.  Exponential in the worst case;
    for small graphs, to sanity check the O(m) average bound.  A recursion
    deeper than 60 answers "in the set", as in the reference."""
    indptr, indices, _, _ = g.csr()
    count = 0

    def in_mis(v, depth=0):
        nonlocal count
        if depth > 60:
            return True
        nbrs = indices[indptr[v]:indptr[v + 1]]
        lower = nbrs[rank[nbrs] < rank[v]]
        for u in lower[np.argsort(rank[lower], kind="stable")]:
            count += 1
            if in_mis(int(u), depth + 1):
                return False
        return True

    for v in range(g.n):
        in_mis(v)
    return count
