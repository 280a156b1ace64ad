"""GIN (Xu et al., arXiv:1810.00826), gin-tu config: 5 layers, d_hidden 64,
sum aggregator, learnable eps, graph classification; the JAX package's
``models/gnn/gin.py`` as an ``nn.Module``.

A reference layer computes ``mlp2((1 + eps) x + agg)`` with ``agg`` the
``segment_sum`` of the senders' rows.  Its first linear distributes over
the sum, and the port takes it so:

    h = (1 + eps) (x @ W1) + segment_matmul(x, nbr, W1) + b1

where ``segment_matmul`` is the Hopper kernel's ``(sum_k x[nbr[n, k]]) @
W1`` on the card (its plain version on the CPU), one launch a layer.  This
equals the reference's layer up to f32 rounding.

A batch that carries ``nbr`` (a sampled block) is read through it alone.
An edge-list batch gets a table no wider than ``K_CAP``; the in-edges of a
row past its first ``K_CAP`` (a hub's) are summed apart, by ``index_add_``
of their senders' rows into an f32 sum for the hub rows only, multiplied
by W1 and added into those rows: W1 distributes over that sum too.  Which
layout a batch takes follows from its shape, never from a failed build or
launch.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...devices import resolve_device
from ...kernels.segment_matmul.ops import segment_matmul
from .common import (GraphBatch, graph_readout, init_linear, init_mlp2,
                     linear, split_neighbors)

# Slots of an edge-list batch's in-neighbour table.  The table then takes
# O(N K_CAP) memory whatever the largest in-degree (at ogb_products' scale,
# 2^22 rows, 512 MiB instead of the 2.3 TB of a table as wide as its
# largest in-degree, 137,718), and the edges past it O(E).  32 is above the
# sampled blocks' 15 slots and above the average in-degree of the
# full-batch GNN_SHAPES graphs (Cora 3.9, ogb_products' RMAT stand-in
# 24.3), so most rows fit whole and segment_matmul reads their edges; only
# the tails of hubs go to the edge list.
K_CAP = 32


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_feat: int = 64
    d_hidden: int = 64
    n_classes: int = 2
    dtype: torch.dtype = torch.float32


def init_params(cfg: GINConfig, generator: torch.Generator):
    """The reference's parameter shapes and scales, drawn from
    ``generator`` on its device: {"layers": [{"mlp": {"l1", "l2"}, "eps"}],
    "readout"}, each linear {"w" (d_in, d_out), "b"}."""
    layers = []
    d_in = cfg.d_feat
    for _ in range(cfg.n_layers):
        layers.append({
            "mlp": init_mlp2(generator, d_in, cfg.d_hidden, cfg.d_hidden,
                             cfg.dtype),
            "eps": torch.zeros((), dtype=cfg.dtype,
                               device=generator.device)})
        d_in = cfg.d_hidden
    return {"layers": layers,
            "readout": init_linear(generator, cfg.d_hidden, cfg.n_classes,
                                   cfg.dtype)}


def _linear_params(p) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t) for k, t in p.items()})


class GINLayer(nn.Module):
    """One layer's parameters: ``mlp`` ("l1", "l2", each "w" and "b") and
    the scalar ``eps``."""

    def __init__(self, p):
        super().__init__()
        self.mlp = nn.ModuleDict({k: _linear_params(p["mlp"][k])
                                  for k in ("l1", "l2")})
        self.eps = nn.Parameter(p["eps"])


class GIN(nn.Module):
    """GIN on one device.

    ``params`` is laid out as :func:`init_params` returns it (or as
    ``repro_torch.convert.gnn_params_from_reference`` carries it over from
    the JAX package); without it the parameters are drawn from a
    ``torch.Generator`` seeded with ``seed`` on the device.  The module
    takes the given tensors as its parameters without a copy (on their
    device), so training updates them in place.  It runs on CUDA unless
    ``device`` asks for the CPU, and raises where CUDA is missing.
    """

    def __init__(self, cfg: GINConfig, params=None, *, device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device, "GIN")
        if params is None:
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(
                seed))
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers of parameters "
                             f"for a {cfg.n_layers}-layer config")
        self.layers = nn.ModuleList(GINLayer(p) for p in params["layers"])
        self.readout = _linear_params(params["readout"])
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.readout["w"].device

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        """Logits (n_graphs, n_classes) in ``cfg.dtype``."""
        if batch.node_feat.device != self.device:
            raise ValueError(f"batch on {batch.node_feat.device}, model on "
                             f"{self.device}")
        x = batch.node_feat.to(self.cfg.dtype)
        nbr, hubs = batch.nbr, None
        if nbr is None:
            nbr, over_s, over_r = split_neighbors(
                batch.senders, batch.receivers, batch.edge_mask,
                batch.n_nodes, cap=K_CAP)
            if over_r.numel():
                hubs, hub_of = torch.unique_consecutive(over_r,
                                                        return_inverse=True)
        for layer in self.layers:
            l1 = layer.mlp["l1"]
            w1 = l1["w"].to(x.dtype)
            h = ((1.0 + layer.eps.to(x.dtype)) * (x @ w1)
                 + segment_matmul(x, nbr, w1) + l1["b"].to(x.dtype))
            if hubs is not None:
                agg = torch.zeros((hubs.shape[0], x.shape[1]),
                                  dtype=torch.float32, device=x.device)
                agg.index_add_(0, hub_of, x[over_s].float())
                h = h.index_add(0, hubs, (agg @ w1.float()).to(h.dtype))
            x = linear(layer.mlp["l2"], torch.relu(h))
        pooled = graph_readout(x, batch.graph_ids, batch.n_graphs,
                               batch.node_mask, op="sum")
        return linear(self.readout, pooled)

    def loss_fn(self, batch: GraphBatch):
        """Mean cross-entropy of the (n_graphs,) labels, in f32: (nll,
        {"nll": nll})."""
        logits = self(batch).float()
        labels = batch.labels.long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, None])[:, 0]
        nll = (logz - gold).mean()
        return nll, {"nll": nll}
