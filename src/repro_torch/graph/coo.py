"""Graph containers used across the port (numpy, host side).

The same ``UGraph`` as the JAX package's ``repro.graph.coo``: undirected
edges stored once as ``edges[(E, 2)]`` int32, optional float32 weights.
Solvers move the arrays they need onto their torch device themselves.
``degrees``, ``csr`` and ``padded_adj`` are vectorized (the reference loops
in Python over the vertices in ``padded_adj``) with array-equal outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class UGraph:
    """Undirected graph in COO form (each edge stored once, u < v not
    required)."""

    n: int
    edges: np.ndarray  # (E, 2) int32
    weights: Optional[np.ndarray] = None  # (E,) float32

    def __post_init__(self):
        self.edges = np.asarray(self.edges, dtype=np.int32).reshape(-1, 2)
        if self.weights is not None:
            self.weights = np.asarray(self.weights, dtype=np.float32)
            if self.weights.shape[0] != self.edges.shape[0]:
                raise ValueError("weights must hold one value per edge")

    @property
    def m(self) -> int:
        return int(self.edges.shape[0])

    def with_unit_weights(self) -> "UGraph":
        return UGraph(self.n, self.edges, np.ones(self.m, np.float32))

    def with_random_weights(self, seed: int = 0) -> "UGraph":
        rng = np.random.default_rng(seed)
        # distinct weights => unique MSF, simplifies testing
        w = rng.permutation(self.m).astype(np.float32) + 1.0
        return UGraph(self.n, self.edges, w)

    def with_degree_weights(self) -> "UGraph":
        """Paper Section 5.2: weight(u,v) proportional to deg(u)+deg(v)."""
        deg = self.degrees()
        w = (deg[self.edges[:, 0]] + deg[self.edges[:, 1]]).astype(np.float32)
        # tie-break by edge id to keep the MSF unique
        w = w + np.arange(self.m, dtype=np.float32) / max(self.m, 1) * 0.5
        return UGraph(self.n, self.edges, w)

    def degrees(self) -> np.ndarray:
        return np.bincount(self.edges.ravel(), minlength=self.n).astype(
            np.int64)

    def dedup(self) -> "UGraph":
        """Remove duplicate undirected edges and self loops (keep the min
        weight)."""
        e = np.sort(self.edges, axis=1)
        keep = e[:, 0] != e[:, 1]
        e = e[keep]
        w = self.weights[keep] if self.weights is not None else None
        if e.shape[0] == 0:
            return UGraph(self.n, e.reshape(0, 2), w)
        key = e[:, 0].astype(np.int64) * self.n + e[:, 1]
        if w is None:
            _, idx = np.unique(key, return_index=True)
            return UGraph(self.n, e[idx], None)
        order = np.lexsort((w, key))
        key_sorted = key[order]
        first = np.ones(len(order), bool)
        first[1:] = key_sorted[1:] != key_sorted[:-1]
        sel = order[first]
        return UGraph(self.n, e[sel], w[sel])

    def symmetric(self):
        """Return (senders, receivers, weights, eids) with both directions."""
        s = np.concatenate([self.edges[:, 0], self.edges[:, 1]])
        r = np.concatenate([self.edges[:, 1], self.edges[:, 0]])
        eid = np.concatenate([np.arange(self.m),
                              np.arange(self.m)]).astype(np.int32)
        if self.weights is not None:
            w = np.concatenate([self.weights, self.weights])
        else:
            w = None
        return s.astype(np.int32), r.astype(np.int32), w, eid

    def csr(self):
        """CSR over the symmetric view: (indptr, indices, weights, eids)."""
        s, r, w, eid = self.symmetric()
        order = np.argsort(s, kind="stable")
        s, r, eid = s[order], r[order], eid[order]
        w = w[order] if w is not None else None
        indptr = np.zeros(self.n + 1, np.int64)
        np.cumsum(np.bincount(s, minlength=self.n), out=indptr[1:])
        return indptr, r, w, eid

    def padded_adj(self, max_deg: Optional[int] = None):
        """Dense (n, max_deg) adjacency with -1 padding.

        Returns (nbr_ids, nbr_weights, nbr_eids): the first ``max_deg``
        CSR entries of each vertex.  Used after ternarization where
        max_deg <= 3, and for small test graphs.
        """
        indptr, indices, w, eid = self.csr()
        deg = np.diff(indptr)
        md = int(deg.max()) if max_deg is None and self.n else (max_deg or 1)
        md = max(md, 1)
        nbr = np.full((self.n, md), -1, np.int32)
        nbw = np.full((self.n, md), np.inf, np.float32)
        nbe = np.full((self.n, md), -1, np.int32)
        src = np.repeat(np.arange(self.n, dtype=np.int64), deg)
        col = np.arange(len(indices), dtype=np.int64) - indptr[src]
        keep = col < md
        src, col = src[keep], col[keep]
        nbr[src, col] = indices[keep]
        if w is not None:
            nbw[src, col] = w[keep]
        nbe[src, col] = eid[keep]
        return nbr, nbw, nbe
