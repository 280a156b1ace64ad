"""Shape-bucketed graph batching for ``AmpcEngine.solve_many`` (port).

A copy of the JAX package's ``repro.graph.batching``: round ``(n, m)`` up to
the next power of two and pad every graph of a bucket to that shape, so a
fleet of mixed-size graphs falls into ``O(log)`` buckets, each run as one
launch that reuses one cached solver.

Padding conventions (consumed by the batch adapters in
``repro_torch.ampc.solvers``):

  * padded **edges** are ``(0, 0)`` self-loops with ``edge_mask`` False —
    every batched fixpoint either masks them out explicitly or relies on
    self-loops being inert in its update rule;
  * padded **vertices** (ids ``n..n_bucket``) have no valid incident edges,
    so they resolve trivially and are sliced away by :func:`unpad`;
  * padded **weights** are ``+inf`` so they can never win a min-reduction.

Host-side only (numpy); the adapters move the arrays to their device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .coo import UGraph


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    x = max(int(x), 1)
    return 1 << (x - 1).bit_length()


def bucket_shape(n: int, m: int) -> Tuple[int, int]:
    """The ``(n_bucket, m_bucket)`` a graph with ``n`` vertices and ``m``
    edges pads into: both sides rounded up to the next power of two."""
    return next_pow2(n), next_pow2(m)


@dataclasses.dataclass
class GraphBatch:
    """One shape bucket of a ``solve_many`` fleet, padded and stacked.

    ``indices[i]`` is the position of ``graphs[i]`` in the original fleet so
    results can be scattered back in input order.  ``edges`` / ``weights``
    are padded per the module conventions; ``edge_mask`` / ``node_mask``
    mark the real entries.
    """

    n_bucket: int
    m_bucket: int
    graphs: List[UGraph]
    indices: List[int]
    n: np.ndarray            # (B,) int32 actual vertex counts
    m: np.ndarray            # (B,) int32 actual edge counts
    edges: np.ndarray        # (B, m_bucket, 2) int32, padding = (0, 0)
    edge_mask: np.ndarray    # (B, m_bucket) bool
    node_mask: np.ndarray    # (B, n_bucket) bool
    weights: Optional[np.ndarray] = None  # (B, m_bucket) f32, padding = +inf

    def __len__(self) -> int:
        return len(self.graphs)

    @property
    def key(self) -> Tuple[int, int]:
        return (self.n_bucket, self.m_bucket)

    def padded_symmetric(self):
        """Batched doubled-directed view: (senders, receivers, edge_ok),
        each ``(B, 2 * m_bucket)``; padding lanes point at vertex 0 with
        ``edge_ok`` False."""
        B, mb = self.edges.shape[:2]
        senders = np.concatenate([self.edges[:, :, 0], self.edges[:, :, 1]],
                                 axis=1).astype(np.int32)
        receivers = np.concatenate([self.edges[:, :, 1], self.edges[:, :, 0]],
                                   axis=1).astype(np.int32)
        edge_ok = np.concatenate([self.edge_mask, self.edge_mask], axis=1)
        return senders, receivers, edge_ok


def pad_graphs(graphs: Sequence[UGraph], indices: Sequence[int],
               n_bucket: int, m_bucket: int) -> GraphBatch:
    """Stack ``graphs`` into one padded ``GraphBatch`` of the given bucket."""
    B = len(graphs)
    ns = np.array([g.n for g in graphs], np.int32)
    ms = np.array([g.m for g in graphs], np.int32)
    if not ((ns <= n_bucket).all() and (ms <= m_bucket).all()):
        raise ValueError("graph exceeds bucket shape")
    edges = np.zeros((B, m_bucket, 2), np.int32)
    edge_mask = np.zeros((B, m_bucket), bool)
    node_mask = np.zeros((B, n_bucket), bool)
    any_weights = any(g.weights is not None for g in graphs)
    weights = (np.full((B, m_bucket), np.inf, np.float32) if any_weights
               else None)
    for b, g in enumerate(graphs):
        edges[b, :g.m] = g.edges
        edge_mask[b, :g.m] = True
        node_mask[b, :g.n] = True
        if weights is not None and g.weights is not None:
            weights[b, :g.m] = g.weights
    return GraphBatch(n_bucket=n_bucket, m_bucket=m_bucket,
                      graphs=list(graphs), indices=list(indices),
                      n=ns, m=ms, edges=edges, edge_mask=edge_mask,
                      node_mask=node_mask, weights=weights)


def bucketize(graphs: Sequence[UGraph]) -> Dict[Tuple[int, int], GraphBatch]:
    """Group a fleet into padded shape buckets, preserving input order
    inside each bucket.  Returns ``{(n_bucket, m_bucket): GraphBatch}``."""
    groups: Dict[Tuple[int, int], Tuple[List[UGraph], List[int]]] = {}
    for i, g in enumerate(graphs):
        key = bucket_shape(g.n, g.m)
        gs, idx = groups.setdefault(key, ([], []))
        gs.append(g)
        idx.append(i)
    return {key: pad_graphs(gs, idx, *key)
            for key, (gs, idx) in groups.items()}


def unpad(row: np.ndarray, size: int) -> np.ndarray:
    """Slice one batch row back to its real length."""
    return np.asarray(row)[:size]
