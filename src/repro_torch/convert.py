"""Carry state from the JAX package into the port.

The AMPC system has no weights: what the two packages share is the input
graph (and the DHT snapshot values the solvers build from it).  These
helpers build a port :class:`~repro_torch.graph.coo.UGraph` from numpy
arrays or from any object with ``.n`` / ``.edges`` / ``.weights``, such as
the JAX package's ``repro.graph.coo.UGraph``, without importing it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .graph.coo import UGraph


def graph_from_arrays(n: int, edges: np.ndarray,
                      weights: Optional[np.ndarray] = None) -> UGraph:
    """A port graph over ``n`` vertices from an (E, 2) edge array and
    optional (E,) weights (copied, as int32 / float32)."""
    edges = np.array(edges, dtype=np.int32, copy=True)
    if weights is not None:
        weights = np.array(weights, dtype=np.float32, copy=True)
    return UGraph(int(n), edges, weights)


def graph_from_reference(g) -> UGraph:
    """A port graph equal to ``g`` (any object with ``.n``, ``.edges`` and
    an optional ``.weights``)."""
    return graph_from_arrays(g.n, g.edges, getattr(g, "weights", None))
