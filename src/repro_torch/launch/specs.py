"""Input specs and runnable steps for every (arch x shape) cell, the
counterpart of the JAX package's ``launch/specs.py``.

Everything here is built on the ``meta`` device: no storage.  Each cell
resolves to a :class:`CellSpec` (the reference's ``Lowerable``): the step,
its arguments (the model, whose parameters are the meta tensors, then
meta tensors, or a ``GraphBatch`` of them), each argument's placements on
a mesh (``launch.sharding``), the donated arguments, and the analytic
``model_flops`` of the reference's formulas (6·N·D training, 2·N·D
inference over the active parameters; ``_gnn_flops``; the SASRec terms).

What differs from the reference, all in ``notes``:
  * LM training cells run the flash kernels (``attention_impl="pallas"``,
    the port's training path; their ``meta`` branch counts their FLOPs);
    the reference's cells lower its chunked XLA attention.  Prefill and
    decode take the xla branches in both packages.
  * gin-tu reads edge lists through ``segment_matmul``'s neighbour table,
    whose width and overflow depend on the data: the cell gives them as
    explicit sizes (width ``gin.K_CAP``, the fewest edges any graph of the
    cell's sizes leaves past that width, every overflow edge its own hub).
    On a mesh the table's rows lie with the node rows over every axis, the
    overflow edges over every axis, the hub rows replicated.

On a ``DeviceMesh`` every cell's step runs under a ``ShardCtx`` (the
dry-run's ``measure_mesh``): each step takes ``sctx=``, and the GNN and
SASRec placements here are those ``steps.place_gnn``,
``steps.place_graph_batch`` and ``steps.place_rec`` give.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.registry import ArchEntry, get
from ..configs.shapes import ShapeSpec, sampled_block_sizes
from ..models.gnn import gin
from ..models.gnn.common import GraphBatch
from ..models.sasrec import SASRec
from ..models.transformer import TransformerConfig, TransformerLM
from ..optim import adamw
from . import steps
from .mesh import data_axes, mesh_axes, n_chips
from .sharding import (Sharding, batch_sharding, graph_batch_shardings,
                       kv_cache_shardings, lm_param_shardings,
                       rec_param_shardings, replicated)

META = torch.device("meta")


@dataclasses.dataclass
class CellSpec:
    arch_id: str
    shape_name: str
    kind: str
    step: Callable              # step(*args) runs the cell once
    args: Tuple
    placements: Tuple           # per arg: Sharding, or {name: Sharding}
    donate_argnums: Tuple[int, ...]
    model_flops: float          # 6·N·D train / 2·N·D inference (active)
    notes: str = ""

    def run(self):
        return self.step(*self.args)


def _pad_to(x: int, mult: int) -> int:
    return int(math.ceil(x / mult)) * mult


def _opt_cfg() -> adamw.AdamWConfig:
    return adamw.AdamWConfig()


def _with_opt(step, opt_cfg):
    """``step(model, *args)`` for a training step that takes the AdamW
    config second."""
    def run(model, *args, **kwargs):
        return step(model, opt_cfg, *args, **kwargs)
    return run


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _params(model) -> Dict[str, torch.Tensor]:
    return dict(model.named_parameters())


def _opt_placements(mesh, opt_state, rule) -> Dict[str, Any]:
    return {"m": rule(mesh, opt_state["m"]), "v": rule(mesh, opt_state["v"]),
            "step": Sharding(mesh)}


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------
def _lm_cell(entry: ArchEntry, shape: ShapeSpec, mesh,
             overrides=None) -> CellSpec:
    cfg: TransformerConfig = entry.config
    dpn = math.prod(mesh_axes(mesh)[a] for a in data_axes(mesh))
    B, SL = shape.global_batch, shape.seq_len
    notes = []
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat="dots", attention_impl="pallas")
        notes.append("attention: the flash kernels (attention_impl=pallas)")
    opt_overrides = {}
    if overrides:
        overrides = dict(overrides)
        for k in list(overrides):
            if k.startswith("opt_"):
                opt_overrides[k[4:]] = overrides.pop(k)
        cfg = dataclasses.replace(cfg, **overrides)
    model = TransformerLM(cfg, device=META, dtype=torch.bfloat16)
    p_sh = lm_param_shardings(mesh, _params(model))
    n_active = cfg.active_param_count()

    if shape.kind == "train":
        opt_cfg = dataclasses.replace(_opt_cfg(), **opt_overrides)
        opt_state = adamw.init_state(model, opt_cfg)
        tok = _meta((B, SL), torch.int32)
        b_sh = batch_sharding(mesh, 2)
        return CellSpec(
            entry.arch_id, shape.name, shape.kind,
            _with_opt(steps.lm_train_step, opt_cfg),
            (model, opt_state, tok, _meta((B, SL), torch.int32)),
            (p_sh, _opt_placements(mesh, opt_state, lm_param_shardings),
             b_sh, b_sh), (0, 1),
            model_flops=6.0 * n_active * B * SL, notes="; ".join(notes))

    if shape.kind == "prefill":
        return CellSpec(
            entry.arch_id, shape.name, shape.kind, steps.lm_prefill_step,
            (model, _meta((B, SL), torch.int32)),
            (p_sh, batch_sharding(mesh, 2)), (),
            model_flops=2.0 * n_active * B * SL)

    cache_shape = steps.lm_cache_shape(cfg, B, SL)
    cache = {"k": _meta(cache_shape, torch.bfloat16),
             "v": _meta(cache_shape, torch.bfloat16),
             "length": _meta((B,), torch.int32)}
    c_sh = {"k": kv_cache_shardings(mesh, cache_shape, B),
            "v": kv_cache_shardings(mesh, cache_shape, B),
            "length": Sharding(mesh)}
    t_sh = (batch_sharding(mesh, 1) if B % dpn == 0 and B >= dpn
            else Sharding(mesh))
    return CellSpec(
        entry.arch_id, shape.name, shape.kind, steps.lm_decode_step,
        (model, cache, _meta((B,), torch.int32)), (p_sh, c_sh, t_sh), (1,),
        model_flops=2.0 * n_active * B, notes=f"cache_len={cache_shape[2]}")


# --------------------------------------------------------------------------
# GNN cells
# --------------------------------------------------------------------------
def _gnn_sizes(shape: ShapeSpec, chips: int):
    """(N, E, n_graphs, d_feat): node and directed-edge counts padded to
    the chip count, as the reference pads them."""
    if shape.kind == "gnn_sampled":
        n_nodes, n_edges_dir = sampled_block_sizes(shape)
        n_graphs, d_feat = 1, shape.d_feat
    elif shape.kind == "gnn_batched":
        n_nodes = shape.n_nodes * shape.n_graphs
        n_edges_dir = 2 * shape.n_edges * shape.n_graphs
        n_graphs, d_feat = shape.n_graphs, 64
    else:
        n_nodes, n_edges_dir = shape.n_nodes, 2 * shape.n_edges
        n_graphs, d_feat = 1, shape.d_feat
    return (_pad_to(n_nodes, chips), _pad_to(n_edges_dir, chips), n_graphs,
            d_feat)


def gin_table_sizes(N: int, E: int) -> Tuple[int, int, int]:
    """(width, overflow edges, hubs) of gin-tu's neighbour table for N
    nodes and E directed edges, as the dry-run sizes it: ``gin.K_CAP``
    slots a row, the E - K_CAP·N edges no graph of these sizes can keep
    inside the table (0 where they fit), each its own hub row (at most
    N)."""
    over = max(0, E - gin.K_CAP * N)
    return gin.K_CAP, over, min(N, over)


def _gnn_batch_struct(entry: ArchEntry, shape: ShapeSpec, mesh
                      ) -> Tuple[GraphBatch, Dict[str, Sharding]]:
    """(batch of meta tensors, {field: Sharding})."""
    N, E, n_graphs, d_feat = _gnn_sizes(shape, n_chips(mesh))
    arch = entry.arch_id
    fields = {}
    if arch in ("gcn-cora", "gin-tu"):
        fields["node_feat"] = _meta((N, d_feat), torch.float32)
    else:   # schnet / mace read positions and species
        fields["positions"] = _meta((N, 3), torch.float32)
        fields["species"] = _meta((N,), torch.int32)
    if arch == "gcn-cora":       # node classification
        fields["labels"] = _meta((N,), torch.int32)
    elif arch == "gin-tu":       # graph classification
        fields["labels"] = _meta((n_graphs,), torch.int32)
    else:                        # energies per graph
        fields["labels"] = _meta((n_graphs,), torch.float32)
    if arch == "gin-tu":
        width, over, hubs = gin_table_sizes(N, E)
        fields["nbr"] = _meta((N, width), torch.int32)
        if over:
            fields["overflow"] = (_meta((over,), torch.int64),
                                  _meta((over,), torch.int64),
                                  _meta((hubs,), torch.int64))
    batch = GraphBatch(
        senders=_meta((E,), torch.int32), receivers=_meta((E,), torch.int32),
        node_mask=_meta((N,), torch.bool), edge_mask=_meta((E,), torch.bool),
        graph_ids=_meta((N,), torch.int32), n_graphs=n_graphs, **fields)
    return batch, graph_batch_shardings(mesh, batch)


def _gnn_flops(entry: ArchEntry, cfg, batch: GraphBatch) -> float:
    """The reference's analytic useful FLOPs (fwd+bwd ~ 3x fwd):
    GCN/GIN: per-edge add (2d) + per-node dense transform;
    SchNet:  per-edge filter MLP + cfconv; MACE: per-edge radial MLPs +
    moment accumulation over 13 tensor components."""
    E = batch.senders.shape[0]
    N = batch.node_mask.shape[0]
    arch = entry.arch_id
    if arch == "gcn-cora":
        d_in, d = cfg.d_feat, cfg.d_hidden
        fwd = E * 2 * (d + cfg.n_classes) + N * 2 * (d_in * d
                                                     + d * cfg.n_classes)
    elif arch == "gin-tu":
        d_in, d = cfg.d_feat, cfg.d_hidden
        fwd = cfg.n_layers * (E * 2 * d + N * 4 * d * d) + N * 2 * d_in * d
    elif arch == "schnet":
        d, r = cfg.d_hidden, cfg.n_rbf
        fwd = cfg.n_interactions * (E * 2 * (r * d + d * d + d)
                                    + N * 4 * d * d)
    else:  # mace
        d, r = cfg.d_hidden, cfg.n_rbf
        per_edge = 3 * 2 * (r * d + d * d) + 2 * d * 13
        per_node = 6 * d * d + 6 * 2 * d * 13
        fwd = cfg.n_layers * (E * per_edge + N * per_node)
    return 3.0 * fwd


def _gnn_cell(entry: ArchEntry, shape: ShapeSpec, mesh) -> CellSpec:
    cfg = entry.config
    if entry.arch_id in ("gcn-cora", "gin-tu"):
        # the input layer's width follows the cell's dataset
        df = (shape.d_feat if shape.kind in ("gnn_full", "gnn_sampled")
              else 64)
        cfg = dataclasses.replace(cfg, d_feat=df)
    model = steps.GNN_MODELS[entry.arch_id](cfg, device=META)
    opt_state = adamw.init_state(model)
    batch, b_sh = _gnn_batch_struct(entry, shape, mesh)
    notes = ""
    if batch.nbr is not None:
        width, over, hubs = gin_table_sizes(batch.n_nodes,
                                            batch.senders.shape[0])
        notes = (f"neighbour table: explicit sizes, width {width}, "
                 f"{over} overflow edges into {hubs} hub rows")
    return CellSpec(
        entry.arch_id, shape.name, shape.kind,
        _with_opt(steps.gnn_train_step, _opt_cfg()),
        (model, opt_state, batch),
        (replicated(mesh, _params(model)),
         _opt_placements(mesh, opt_state, replicated), b_sh), (0, 1),
        model_flops=_gnn_flops(entry, cfg, batch), notes=notes)


# --------------------------------------------------------------------------
# RecSys cells
# --------------------------------------------------------------------------
def _rec_cell(entry: ArchEntry, shape: ShapeSpec, mesh) -> CellSpec:
    cfg = entry.config
    model = SASRec(cfg, device=META)
    p_sh = rec_param_shardings(mesh, _params(model))
    B = shape.global_batch
    dpn = math.prod(mesh_axes(mesh)[a] for a in data_axes(mesh))
    seq = _meta((B, cfg.seq_len), torch.int32)
    b2 = (batch_sharding(mesh, 2) if B % dpn == 0 and B >= dpn
          else Sharding(mesh))
    d_model_flops = 2.0 * cfg.embed_dim * cfg.embed_dim * 10  # per token
    if shape.kind == "rec_train":
        opt_state = adamw.init_state(model)
        return CellSpec(
            entry.arch_id, shape.name, shape.kind,
            _with_opt(steps.rec_train_step, _opt_cfg()),
            (model, opt_state, seq, _meta(seq.shape, torch.int32),
             _meta(seq.shape, torch.int32)),
            (p_sh, _opt_placements(mesh, opt_state, rec_param_shardings),
             b2, b2, b2), (0, 1),
            model_flops=3 * B * cfg.seq_len * d_model_flops)
    if shape.kind == "rec_serve":
        n_cand = 1024
        return CellSpec(
            entry.arch_id, shape.name, shape.kind, steps.rec_serve_step,
            (model, seq, _meta((B, n_cand), torch.int32)), (p_sh, b2, b2), (),
            model_flops=B * (cfg.seq_len * d_model_flops
                             + 2 * n_cand * cfg.embed_dim))
    # retrieval: 1 user against the full table
    return CellSpec(
        entry.arch_id, shape.name, shape.kind, steps.rec_retrieval_step,
        (model, seq), (p_sh, Sharding(mesh)), (),
        model_flops=B * (cfg.seq_len * d_model_flops
                         + 2 * cfg.n_items * cfg.embed_dim))


# --------------------------------------------------------------------------
def build_cell(arch_id: str, shape_name: str, mesh,
               overrides: Optional[dict] = None,
               shape_overrides: Optional[dict] = None) -> CellSpec:
    """The cell's :class:`CellSpec` on ``mesh`` (a ``MeshShape`` or a
    ``DeviceMesh``: only its axis sizes are read).  ``overrides`` replace
    fields of an LM's config (``opt_``-prefixed ones the AdamW config's),
    ``shape_overrides`` fields of the shape (a cut batch, say)."""
    entry = get(arch_id)
    shape = dataclasses.replace(entry.shapes[shape_name],
                                **(shape_overrides or {}))
    if entry.family == "lm":
        return _lm_cell(entry, shape, mesh, overrides=overrides)
    if entry.family == "gnn":
        return _gnn_cell(entry, shape, mesh)
    return _rec_cell(entry, shape, mesh)


def input_specs(arch_id: str, shape_name: str, mesh):
    """The cell's arguments, every tensor on ``meta``: the model (its
    parameters), then the step's inputs."""
    return build_cell(arch_id, shape_name, mesh).args
