"""SchNet (Schütt et al., arXiv:1706.08566), schnet config: 3 interaction
blocks, d_hidden 64, 300 Gaussian RBFs, cutoff 10 Å; the JAX package's
``models/gnn/schnet.py`` as an ``nn.Module``.

Continuous-filter convolution: W(r_ij) ⊙ h_j, gathered from the senders
and scattered into the receivers by ``index_add_``, under a cosine
envelope; per-atom energies summed per graph by ``graph_readout`` (a
one-hot product on the card).  No kernel runs.

Under a ``ShardCtx`` (``sctx``) the per-edge RBF filter runs on this
rank's edges: the positions are gathered (all-gathered, then read) for
its senders and its receivers, the species embeddings read from the
replicated table, and the convolution scattered by ``common``'s regions;
the energies are replicated.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ...devices import randn
from .common import (GraphBatch, GraphModel, gather, graph_readout,
                     init_linear, init_mlp2, linear, mlp2, scatter_sum)


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 100
    dtype: torch.dtype = torch.float32


def shifted_softplus(x):
    """softplus(x) - log 2, softplus as the reference's ``logaddexp(x,
    0)`` (max(x, 0) + log1p(exp(-|x|)): ``F.softplus``'s log1p(exp(x))
    rounds otherwise, and an energy summed over many atoms adds those
    roundings up)."""
    return torch.logaddexp(x, x.new_zeros(())) - math.log(2.0)


def rbf_expand(dist, n_rbf: int, cutoff: float):
    centers = torch.linspace(0.0, cutoff, n_rbf, device=dist.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def envelope(dist, cutoff: float):
    """The smooth cosine cutoff: 0.5 (cos(pi min(d / c, 1)) + 1)."""
    return 0.5 * (torch.cos(math.pi * torch.clamp(dist / cutoff, 0, 1))
                  + 1.0)


def init_params(cfg: SchNetConfig, generator: torch.Generator):
    """The reference's parameter shapes and scales, drawn from
    ``generator`` on its device: {"embed" (n_species, d), "interactions":
    [{"filter", "in_lin" (no bias), "out"}], "energy_head"}."""
    d = cfg.d_hidden
    p = {"embed": randn((cfg.n_species, d), generator, cfg.dtype) * 0.1,
         "interactions": []}
    for _ in range(cfg.n_interactions):
        p["interactions"].append({
            "filter": init_mlp2(generator, cfg.n_rbf, d, d, cfg.dtype),
            "in_lin": init_linear(generator, d, d, cfg.dtype, bias=False),
            "out": init_mlp2(generator, d, d, d, cfg.dtype),
        })
    p["energy_head"] = init_mlp2(generator, d, d // 2, 1, cfg.dtype)
    return p


class SchNet(GraphModel):
    """SchNet on one device (see :class:`~.common.GraphModel`)."""
    init = staticmethod(init_params)
    depth = ("interactions", "n_interactions")

    def forward(self, batch: GraphBatch, sctx=None) -> torch.Tensor:
        """Per-graph energies (n_graphs,) in ``cfg.dtype``."""
        cfg = self.cfg
        self._check_device(batch.positions)
        n = batch.n_nodes
        x = gather(self["embed"].to(cfg.dtype), batch.species, sctx)
        ri = gather(batch.positions, batch.receivers, sctx)
        rj = gather(batch.positions, batch.senders, sctx)
        dist = torch.sqrt(torch.clamp(((ri - rj) ** 2).sum(-1), min=1e-12))
        rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff).to(cfg.dtype)
        env = envelope(dist, cfg.cutoff)[:, None].to(cfg.dtype)
        for blk in self["interactions"]:
            w = mlp2(blk["filter"], rbf, act=shifted_softplus) * env
            hj = gather(linear(blk["in_lin"], x), batch.senders, sctx)
            agg = scatter_sum(hj * w, batch.receivers, n, batch.edge_mask,
                              sctx)
            x = x + mlp2(blk["out"], agg, act=shifted_softplus)
        atom_e = mlp2(self["energy_head"], x, act=shifted_softplus)[:, 0]
        return graph_readout(atom_e, batch.graph_ids, batch.n_graphs,
                             batch.node_mask, op="sum", sctx=sctx)

    def loss_fn(self, batch: GraphBatch, sctx=None):
        """Mean squared error of the (n_graphs,) energies, in f32: (mse,
        {"mse": mse})."""
        return energy_mse(self(batch, sctx=sctx), batch.labels)


def energy_mse(energy, target):
    """(mse, {"mse": mse}) of per-graph energies against their targets,
    in f32 (SchNet's and MACE's loss)."""
    mse = ((energy.float() - target.float()) ** 2).mean()
    return mse, {"mse": mse}
