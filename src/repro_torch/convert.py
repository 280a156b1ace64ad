"""Carry state from the JAX package into the port.

The AMPC system has no weights: what the two packages share is the input
graph (and the DHT snapshot values the solvers build from it).  The graph
helpers build a port :class:`~repro_torch.graph.coo.UGraph` from numpy
arrays or from any object with ``.n`` / ``.edges`` / ``.weights``, such as
the JAX package's ``repro.graph.coo.UGraph``, without importing it.  The LM
shares its weights: :func:`lm_params_from_reference` turns the reference's
parameter pytree (as numpy arrays) into the port's parameter dict.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

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


def lm_params_from_reference(cfg, params) -> Dict:
    """The port's LM parameters (``models.transformer.init_params`` layout,
    CPU tensors) from the JAX package's ``init_params`` pytree.

    ``params`` holds array-likes (numpy, or anything ``np.asarray`` takes):
    "embed" (V, d), "layers" with a leading L axis on every leaf,
    "final_norm" and, unless ``cfg.tie_embeddings``, "lm_head" (d, V).
    Matrices keep the reference's ``x @ W`` orientation, so nothing is
    transposed; a tied head is read as ``embed.T`` by the model itself.
    """
    def tensor(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: exact via f32
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True))

    layers = params["layers"]
    n = int(np.shape(layers["ln1"])[0])
    if n != cfg.n_layers:
        raise ValueError(f"reference params have {n} layers, config "
                         f"{cfg.name} has {cfg.n_layers}")
    if "moe" in layers:
        raise NotImplementedError("MoE layers are not ported yet")
    out = {
        "embed": tensor(params["embed"]),
        "layers": [
            {"attn": {k: tensor(np.asarray(a)[i])
                      for k, a in layers["attn"].items()},
             "mlp": {k: tensor(np.asarray(a)[i])
                     for k, a in layers["mlp"].items()},
             "ln1": tensor(np.asarray(layers["ln1"])[i]),
             "ln2": tensor(np.asarray(layers["ln2"])[i])}
            for i in range(n)],
        "final_norm": tensor(params["final_norm"]),
    }
    if cfg.tie_embeddings:
        if "lm_head" in params:
            raise ValueError("tied embeddings, yet the params carry an "
                             "lm_head")
    else:
        out["lm_head"] = tensor(params["lm_head"])
    return out
