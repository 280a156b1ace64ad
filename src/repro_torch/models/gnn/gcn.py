"""GCN (Kipf & Welling, arXiv:1609.02907), gcn-cora config: 2 layers,
d_hidden 16, symmetric normalization with self-loops, node
classification; the JAX package's ``models/gnn/gcn.py`` as an
``nn.Module``.

A layer keeps the reference's order: the linear first, then the gather
and ``index_add_`` scatter of the d_out-wide ``h * dinv`` rows.  No kernel
runs: ``segment_matmul`` would gather the layer's input rows (64 to 1433
wide at GCN's cells) where this gathers 16-wide ones.

Under a ``ShardCtx`` (``sctx``) the node and edge arrays, the labels
among them, lie over every mesh axis (``common``'s regions), and the
loss's masked mean takes its two sums over the global mask, each
all-reduced.
"""
from __future__ import annotations

import dataclasses

import torch

from .common import (GraphBatch, GraphModel, degree, gather, init_linear,
                     linear, scatter_sum)


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_feat: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    dtype: torch.dtype = torch.float32


def init_params(cfg: GCNConfig, generator: torch.Generator):
    """The reference's parameter shapes and scales, drawn from
    ``generator`` on its device: {"layers": [{"w" (d_in, d_out), "b"}]}."""
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {"layers": [init_linear(generator, dims[i], dims[i + 1], cfg.dtype)
                       for i in range(cfg.n_layers)]}


class GCN(GraphModel):
    """GCN on one device (see :class:`~.common.GraphModel`)."""
    init = staticmethod(init_params)

    def forward(self, batch: GraphBatch, sctx=None) -> torch.Tensor:
        """Logits (N, n_classes) in ``cfg.dtype``."""
        self._check_device(batch.node_feat)
        n = batch.n_nodes
        # symmetric normalization with self-loops: deg includes self
        deg = degree(batch.receivers, n, batch.edge_mask, sctx) + 1.0
        dinv = torch.rsqrt(torch.clamp(deg, min=1e-9))[:, None]
        x = batch.node_feat.to(self.cfg.dtype)
        for i, layer in enumerate(self["layers"]):
            h = linear(layer, x)
            msg = gather(h * dinv, batch.senders, sctx)
            agg = scatter_sum(msg, batch.receivers, n, batch.edge_mask,
                              sctx)
            x = (agg + h * dinv) * dinv   # includes the self-loop
            if i < self.cfg.n_layers - 1:
                x = torch.relu(x)
        return x

    def loss_fn(self, batch: GraphBatch, sctx=None):
        """Mean cross-entropy of the (N,) labels over the unmasked nodes,
        in f32: (nll, {"nll": nll})."""
        logits = self(batch, sctx=sctx).float()
        labels = batch.labels.long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, None])[:, 0]
        mask = batch.node_mask
        total = torch.where(mask, logz - gold, 0.0).sum()
        count = mask.sum()
        if sctx is not None:
            total, count = sctx.replicate(total), sctx.replicate(count)
        nll = total / torch.clamp(count, min=1)
        return nll, {"nll": nll}
