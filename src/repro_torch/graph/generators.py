"""Deterministic synthetic graph generators (numpy, host side).

Copies of the JAX package's ``repro.graph.generators`` that the port's
solvers, data pipelines and checks use; the same seed gives array-equal
graphs.
"""
from __future__ import annotations

import numpy as np

from .coo import UGraph


def cycle(n: int, offset: int = 0) -> UGraph:
    u = np.arange(n, dtype=np.int32)
    v = (u + 1) % n
    return UGraph(n, np.stack([u + offset, v + offset], axis=1))


def two_cycles(k: int) -> UGraph:
    """The paper's 2xk family: two disjoint cycles of length k."""
    c1 = cycle(k)
    c2 = cycle(k, offset=k)
    return UGraph(2 * k, np.concatenate([c1.edges, c2.edges], axis=0))


def one_cycle(n: int) -> UGraph:
    return cycle(n)


def path(n: int) -> UGraph:
    u = np.arange(n - 1, dtype=np.int32)
    return UGraph(n, np.stack([u, u + 1], axis=1))


def star(n: int) -> UGraph:
    u = np.zeros(n - 1, np.int32)
    v = np.arange(1, n, dtype=np.int32)
    return UGraph(n, np.stack([u, v], axis=1))


def erdos_renyi(n: int, avg_deg: float, seed: int = 0) -> UGraph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    e = rng.integers(0, n, size=(m, 2), dtype=np.int64).astype(np.int32)
    return UGraph(n, e).dedup()


def rmat(n_log2: int, avg_deg: float, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> UGraph:
    """RMAT power-law generator (Graph500 parameters by default)."""
    n = 1 << n_log2
    m = int(n * avg_deg / 2)
    rng = np.random.default_rng(seed)
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for level in range(n_log2):
        r = rng.random(m)
        # quadrant probabilities a, b, c, d
        go_right = r >= a + b  # bottom half for src bit
        r2 = rng.random(m)
        dst_bit = np.where(go_right, r2 >= c / max(c + (1 - a - b - c), 1e-9),
                           r2 >= a / max(a + b, 1e-9))
        src = src * 2 + go_right
        dst = dst * 2 + dst_bit
    e = np.stack([src, dst], axis=1).astype(np.int32)
    # permute labels so high-degree vertices are not clustered at small ids
    perm = rng.permutation(n).astype(np.int32)
    e = perm[e]
    return UGraph(n, e).dedup()


def grid2d(h: int, w: int) -> UGraph:
    idx = np.arange(h * w).reshape(h, w)
    horiz = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    vert = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return UGraph(h * w, np.concatenate([horiz, vert]).astype(np.int32))


def random_geometric(n: int, radius: float, seed: int = 0, dim: int = 3):
    """Point cloud + radius graph; returns (graph, positions, species).

    Used for the molecular GNN batches (``data.graphs.molecules``).
    """
    rng = np.random.default_rng(seed)
    box = (n / 0.05) ** (1.0 / dim) * radius / 10.0 + radius
    pos = rng.random((n, dim)).astype(np.float32) * box
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    iu, iv = np.where(np.triu(d2 <= radius * radius, k=1))
    g = UGraph(n, np.stack([iu, iv], axis=1).astype(np.int32))
    species = rng.integers(0, 8, size=n).astype(np.int32)
    return g, pos, species


def disjoint_components(sizes, avg_deg: float = 4.0, seed: int = 0) -> UGraph:
    """Union of ER components with the given sizes (for connectivity tests)."""
    parts, off = [], 0
    for i, s in enumerate(sizes):
        g = erdos_renyi(s, avg_deg, seed=seed + i)
        # make each component connected by adding a spanning cycle
        cyc = cycle(s).edges
        parts.append(np.concatenate([g.edges, cyc]) + off)
        off += s
    return UGraph(off, np.concatenate(parts)).dedup()
