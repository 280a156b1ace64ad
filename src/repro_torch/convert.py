"""Carry state from the JAX package into the port.

The AMPC system has no weights: what the two packages share is the input
graph (and the DHT snapshot values the solvers build from it).  The graph
helpers build a port :class:`~repro_torch.graph.coo.UGraph` from numpy
arrays or from any object with ``.n`` / ``.edges`` / ``.weights``, such as
the JAX package's ``repro.graph.coo.UGraph``, without importing it.  The LM
shares its weights: :func:`lm_params_from_reference` turns the reference's
parameter pytree (as numpy arrays) into the port's parameter dict, and
:func:`lm_params_to_reference` a port model's parameters back into the
reference's layout; :func:`gnn_params_from_reference` and
:func:`gnn_params_to_reference` do the same for GIN,
:func:`rec_params_from_reference` and :func:`rec_params_to_reference` for
SASRec, and :func:`adamw_state_from_reference` carries the optimizer state
of any of them over, so both packages can start a training step from one
state.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .graph.coo import UGraph
from .models.gnn.gin import GINConfig
from .models.sasrec import SASRecConfig


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


def _tensor(a) -> torch.Tensor:
    """A CPU tensor of an array-like's values; ml_dtypes' bf16 exactly, via
    f32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy; bf16 comes out as f32 (numpy has no
    bf16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def lm_params_from_reference(cfg, params) -> Dict:
    """The port's LM parameters (``models.transformer.init_params`` layout,
    CPU tensors) from the JAX package's ``init_params`` pytree.

    ``params`` holds array-likes (numpy, or anything ``np.asarray`` takes):
    "embed" (V, d), "layers" with a leading L axis on every leaf,
    "final_norm" and, unless ``cfg.tie_embeddings``, "lm_head" (d, V).
    Matrices keep the reference's ``x @ W`` orientation, so nothing is
    transposed; a tied head is read as ``embed.T`` by the model itself.
    """
    layers = params["layers"]
    n = int(np.shape(layers["ln1"])[0])
    if n != cfg.n_layers:
        raise ValueError(f"reference params have {n} layers, config "
                         f"{cfg.name} has {cfg.n_layers}")
    if "moe" in layers:
        raise NotImplementedError("MoE layers are not ported yet")
    out = {
        "embed": _tensor(params["embed"]),
        "layers": [
            {"attn": {k: _tensor(np.asarray(a)[i])
                      for k, a in layers["attn"].items()},
             "mlp": {k: _tensor(np.asarray(a)[i])
                     for k, a in layers["mlp"].items()},
             "ln1": _tensor(np.asarray(layers["ln1"])[i]),
             "ln2": _tensor(np.asarray(layers["ln2"])[i])}
            for i in range(n)],
        "final_norm": _tensor(params["final_norm"]),
    }
    if cfg.tie_embeddings:
        if "lm_head" in params:
            raise ValueError("tied embeddings, yet the params carry an "
                             "lm_head")
    else:
        out["lm_head"] = _tensor(params["lm_head"])
    return out


def named_lm_params(params: Dict) -> Dict[str, torch.Tensor]:
    """An ``init_params``-layout dict flattened to the names of
    ``TransformerLM.named_parameters()`` ("embed", "layers.3.attn.wq",
    "layers.3.ln1", ..., "final_norm", "lm_head")."""
    out = {"embed": params["embed"]}
    for i, layer in enumerate(params["layers"]):
        for group in ("attn", "mlp"):
            for k, t in layer[group].items():
                out[f"layers.{i}.{group}.{k}"] = t
        out[f"layers.{i}.ln1"] = layer["ln1"]
        out[f"layers.{i}.ln2"] = layer["ln2"]
    out["final_norm"] = params["final_norm"]
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"]
    return out


def gnn_params_from_reference(cfg: GINConfig, params) -> Dict:
    """The port's GIN parameters (``models.gnn.gin.init_params`` layout,
    CPU tensors) from the JAX package's ``gin.init_params`` pytree
    ({"layers": [{"mlp": {"l1", "l2"}, "eps"}], "readout"}) of array-likes.
    Weights keep the reference's ``x @ W`` orientation."""
    if len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"reference params have {len(params['layers'])} "
                         f"layers, config {cfg.name} has {cfg.n_layers}")

    def lin(p):
        return {k: _tensor(a) for k, a in p.items()}

    return {"layers": [{"mlp": {k: lin(layer["mlp"][k]) for k in ("l1", "l2")},
                        "eps": _tensor(layer["eps"])}
                       for layer in params["layers"]],
            "readout": lin(params["readout"])}


def named_gnn_params(params: Dict) -> Dict[str, torch.Tensor]:
    """A GIN ``init_params``-layout dict flattened to the names of
    ``GIN.named_parameters()`` ("layers.0.mlp.l1.w", "layers.0.eps", ...,
    "readout.b")."""
    out = {}
    for i, layer in enumerate(params["layers"]):
        for k in ("l1", "l2"):
            for n, t in layer["mlp"][k].items():
                out[f"layers.{i}.mlp.{k}.{n}"] = t
        out[f"layers.{i}.eps"] = layer["eps"]
    for n, t in params["readout"].items():
        out[f"readout.{n}"] = t
    return out


def gnn_params_to_reference(model) -> Dict:
    """A port ``GIN``'s parameters as numpy in the reference's layout."""
    def lin(p):
        return {k: _array(t) for k, t in p.items()}

    return {"layers": [{"mlp": {k: lin(layer.mlp[k]) for k in ("l1", "l2")},
                        "eps": _array(layer.eps)}
                       for layer in model.layers],
            "readout": lin(model.readout)}


def rec_params_from_reference(cfg: SASRecConfig, params) -> Dict:
    """The port's SASRec parameters (``models.sasrec.init_params`` layout,
    CPU tensors) from the JAX package's ``sasrec.init_params`` pytree
    ({"item_embed", "pos_embed", "blocks": [{"wq", ..., "ln2"}]}) of
    array-likes.  Weights keep the reference's ``x @ W`` orientation."""
    if len(params["blocks"]) != cfg.n_blocks:
        raise ValueError(f"reference params have {len(params['blocks'])} "
                         f"blocks, config {cfg.name} has {cfg.n_blocks}")
    return {"item_embed": _tensor(params["item_embed"]),
            "pos_embed": _tensor(params["pos_embed"]),
            "blocks": [{k: _tensor(a) for k, a in blk.items()}
                       for blk in params["blocks"]]}


def named_rec_params(params: Dict) -> Dict[str, torch.Tensor]:
    """A SASRec ``init_params``-layout dict flattened to the names of
    ``SASRec.named_parameters()`` ("item_embed", "pos_embed",
    "blocks.0.wq", ..., "blocks.1.ln2")."""
    out = {"item_embed": params["item_embed"],
           "pos_embed": params["pos_embed"]}
    for i, blk in enumerate(params["blocks"]):
        for k, t in blk.items():
            out[f"blocks.{i}.{k}"] = t
    return out


def rec_params_to_reference(model) -> Dict:
    """A port ``SASRec``'s parameters as numpy in the reference's
    layout."""
    return {"item_embed": _array(model.item_embed),
            "pos_embed": _array(model.pos_embed),
            "blocks": [{k: _array(t) for k, t in blk.items()}
                       for blk in model.blocks]}


def adamw_state_from_reference(cfg, opt_state) -> Dict:
    """The port's AdamW state (``optim.adamw``: moments keyed by parameter
    name, CPU tensors) from the JAX package's ``adamw.init_state`` /
    ``apply_updates`` state, whose "m" and "v" are pytrees like the
    parameters (f32 or bf16 arrays) and "step" a scalar.  ``cfg`` is the
    model's config: a ``GINConfig``, a ``SASRecConfig`` or an LM's
    ``TransformerConfig``."""
    if isinstance(cfg, GINConfig):
        def named(tree):
            return named_gnn_params(gnn_params_from_reference(cfg, tree))
    elif isinstance(cfg, SASRecConfig):
        def named(tree):
            return named_rec_params(rec_params_from_reference(cfg, tree))
    else:
        def named(tree):
            return named_lm_params(lm_params_from_reference(cfg, tree))
    return {"m": named(opt_state["m"]), "v": named(opt_state["v"]),
            "step": torch.tensor(int(np.asarray(opt_state["step"])),
                                 dtype=torch.int32)}


def lm_params_to_reference(model) -> Dict:
    """A port ``TransformerLM``'s parameters as numpy in the reference's
    layout: every layer leaf stacked along a leading L axis.  f32 leaves
    stay f32; bf16 leaves come out as f32 arrays of the same values (numpy
    has no bf16)."""
    layers = model.layers
    out = {
        "embed": _array(model.embed),
        "layers": {
            group: {k: np.stack([_array(getattr(b, group)[k]) for b in layers])
                    for k in getattr(layers[0], group)}
            for group in ("attn", "mlp")},
        "final_norm": _array(model.final_norm),
    }
    out["layers"]["ln1"] = np.stack([_array(b.ln1) for b in layers])
    out["layers"]["ln2"] = np.stack([_array(b.ln2) for b in layers])
    if not model.cfg.tie_embeddings:
        out["lm_head"] = _array(model.lm_head)
    return out
