"""Sharding rules for every architecture family, the counterpart of the
JAX package's ``launch/sharding.py``, as DTensor placements.

A rule gives a *spec*, one entry a tensor dimension, as a
``PartitionSpec`` does: an axis name, a tuple of axis names, or None.  A
:class:`Sharding` pairs a spec with a mesh (a ``DeviceMesh``, or a
:class:`~.mesh.MeshShape` when only sizes are reckoned) and gives its
``placements``, one a mesh dimension: ``Shard(d)`` on every mesh dimension
whose axis shards tensor dimension d, ``Replicate()`` elsewhere.  A tensor
dimension over ("pod", "data") is ``Shard(d)`` on both, pod first, which
is JAX's row-major order.  That rule and its fallback for an axis that
does not divide live in ``repro_torch.placement``, which the models'
``ShardCtx`` shares.

LM params (Megatron-TP x ZeRO-FSDP), as in the reference:
  * attention/MLP in-projections  (d, out):  ("data", "model")
  * attention/MLP out-projections (in, d):   ("model", "data")
  * MoE experts (E, d, f):                   (None, "data", "model")
  * embedding (V, d):                        ("model", "data")   [vocab-TP]
  * lm_head (d, V):                          ("data", "model")
  * norms / biases / scalars:                replicated
  optimizer state inherits the param rule (ZeRO: state lives sharded).
An axis that does not divide its dimension falls back to replicated.

Leaf paths are the reference's: a port parameter name such as
``layers.3.attn.wq`` or ``layers.0.moe.shared.w_gate`` maps to
``layers/attn/wq`` and ``layers/moe/shared/w_gate`` (dots to slashes, the
layer index dropped: the reference stacks the layers into one leaf with a
leading L dimension, the port keeps one leaf a layer, so its specs have
no L entry).

LM batch: tokens (B, S) -> (dp, None), dp = ("pod", "data") | "data".
KV cache: B >= |dp| -> batch-sharded; B == 1 (long_500k) ->
sequence-sharded cache + head_dim over "model".  GNN: node and edge
arrays over all axes flattened; params replicated.  RecSys: the item
table's rows over "model"; the batch over dp.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Mapping, Tuple

from ..placement import (Spec, axis_size, fix_divisibility, mesh_axes,
                         placements)
from .mesh import data_axes


def param_path(name: str) -> str:
    """The reference's leaf path of a port parameter name."""
    return "/".join(p for p in name.split(".") if not p.isdigit())


def lm_param_spec(path: str, ndim: int, dp) -> Spec:
    """path: '/'-joined path of the leaf (a stacked leaf's leading L
    dimension, where there is one, is replicated: rules index from the
    right)."""
    def stacked(*spec):
        return (None,) * (ndim - len(spec)) + spec

    if re.search(r"embed$", path):
        return ("model", dp)
    if re.search(r"lm_head$", path):
        return (dp, "model")
    if re.search(r"attn/(wq|wk|wv)$", path):
        return stacked(dp, "model")
    if re.search(r"attn/wo$", path):
        return stacked("model", dp)
    if re.search(r"mlp/(w_gate|w_up)$", path):
        return stacked(dp, "model")
    if re.search(r"mlp/w_down$", path):
        return stacked("model", dp)
    if re.search(r"moe/(w_gate|w_up)$", path):
        return stacked(None, dp, "model")
    if re.search(r"moe/w_down$", path):
        return stacked(None, "model", dp)
    if re.search(r"moe/shared/(w_gate|w_up)$", path):
        return stacked(dp, "model")
    if re.search(r"moe/shared/w_down$", path):
        return stacked("model", dp)
    if re.search(r"moe/router$", path):
        return stacked(dp, None)
    return ()  # norms, biases, scalars: replicated


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: the port's ``NamedSharding``."""
    mesh: Any
    spec: Spec = ()

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def local_shape(self, shape) -> Tuple[int, ...]:
        """The shape one device holds of a global ``shape`` (every
        sharded dimension divides: the rules drop the others)."""
        return tuple(n // axis_size(self.mesh, self.spec[i])
                     if i < len(self.spec) else n
                     for i, n in enumerate(shape))

    def distribute(self, tensor):
        """``tensor`` (the same global value on every rank) as a DTensor
        with these placements: each rank keeps its shard of its own copy,
        with no communication."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(tensor, self.mesh, self.placements,
                                 src_data_rank=None)


def _dp(mesh):
    dp = data_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def lm_param_shardings(mesh, params: Mapping[str, Any]) -> Dict[str, Sharding]:
    """{name: Sharding} for a mapping of parameter (or optimizer-state)
    names to tensors, or anything with ``shape``."""
    dp = _dp(mesh)
    out = {}
    for name, leaf in params.items():
        shape = tuple(leaf.shape)
        if not shape:
            out[name] = Sharding(mesh)
            continue
        spec = lm_param_spec(param_path(name), len(shape), dp)
        out[name] = Sharding(mesh, fix_divisibility(spec, shape, mesh))
    return out


def replicated(mesh, params: Mapping[str, Any]) -> Dict[str, Sharding]:
    return {name: Sharding(mesh) for name in params}


def batch_sharding(mesh, ndim: int, batch_axis: int = 0) -> Sharding:
    spec = [None] * ndim
    spec[batch_axis] = _dp(mesh)
    return Sharding(mesh, tuple(spec))


def kv_cache_shardings(mesh, cache_shape, global_batch: int) -> Sharding:
    """cache k/v: (L, B, S, Hkv, hd)."""
    sizes = mesh_axes(mesh)
    dp_size = math.prod(sizes[a] for a in data_axes(mesh))
    L, B, S, Hkv, hd = cache_shape
    model = "model" if hd % sizes["model"] == 0 else None
    if global_batch >= dp_size and global_batch % dp_size == 0:
        return Sharding(mesh, (None, _dp(mesh), None, None, model))
    # long-context single stream: sequence-parallel cache
    seq = "data" if S % sizes["data"] == 0 else None
    return Sharding(mesh, (None, None, seq, None, model))


def flat_shard(mesh, ndim: int, axis: int = 0) -> Sharding:
    """Shard dim ``axis`` over ALL mesh axes (GNN node/edge arrays)."""
    spec = [None] * ndim
    spec[axis] = tuple(mesh_axes(mesh))
    return Sharding(mesh, tuple(spec))


# a GraphBatch's tensor fields, the overflow triple apart
GRAPH_FIELDS = ("senders", "receivers", "node_mask", "edge_mask",
                "graph_ids", "node_feat", "positions", "species", "labels",
                "nbr")


def graph_batch_shardings(mesh, batch) -> Dict[str, Any]:
    """{field: Sharding} of a GNN batch (the port's ``GraphBatch``, its
    tensors or anything with ``shape``): every node and edge array over all
    axes (:func:`flat_shard`), the node labels too, per-graph labels (a
    first dimension other than N) replicated; ``nbr`` with the node rows;
    the ``overflow`` triple (senders, ``hub_of``, hubs) as a tuple: its
    edges over all axes, the hub rows replicated."""
    n = batch.node_mask.shape[0]
    out = {}
    for f in GRAPH_FIELDS:
        t = getattr(batch, f)
        if t is None:
            continue
        per_graph = f == "labels" and t.shape[0] != n
        out[f] = Sharding(mesh) if per_graph else flat_shard(mesh, t.dim())
    if batch.overflow is not None:
        out["overflow"] = (flat_shard(mesh, 1), flat_shard(mesh, 1),
                           Sharding(mesh))
    return out


def rec_param_shardings(mesh, params: Mapping[str, Any]
                        ) -> Dict[str, Sharding]:
    """The item table's rows over "model" where they divide; the rest
    replicated."""
    model = mesh_axes(mesh)["model"]
    return {name: Sharding(mesh, ("model", None))
            if name.endswith("item_embed") and leaf.shape[0] % model == 0
            else Sharding(mesh)
            for name, leaf in params.items()}


def place_params(module, shardings: Mapping[str, Sharding]) -> None:
    """Make each named parameter of ``module`` a DTensor parameter with
    its sharding's placements, in place (a parameter already so placed
    stays).  Every rank must hold the same values."""
    from torch import nn
    from torch.distributed.tensor import DTensor
    for name, sh in shardings.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        p = owner._parameters[leaf]
        if isinstance(p, DTensor) and tuple(p.placements) == sh.placements:
            continue
        if isinstance(p, DTensor):
            new = p.detach().redistribute(sh.mesh, sh.placements)
        else:
            new = sh.distribute(p.detach())
        owner._parameters[leaf] = nn.Parameter(
            new, requires_grad=p.requires_grad)


def place_tensors(tensors: Mapping[str, Any],
                  shardings: Mapping[str, Sharding]) -> Dict[str, Any]:
    """{name: DTensor}: each tensor with its sharding's placements."""
    from torch.distributed.tensor import DTensor
    out = {}
    for name, t in tensors.items():
        sh = shardings[name]
        if isinstance(t, DTensor):
            out[name] = (t if tuple(t.placements) == sh.placements
                         else t.redistribute(sh.mesh, sh.placements))
        else:
            out[name] = sh.distribute(t)
    return out
