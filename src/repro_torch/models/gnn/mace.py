"""MACE (Batatia et al., arXiv:2206.07697), mace config: 2 layers, 128
channels, l_max 2, correlation order 3; the JAX package's
``models/gnn/mace.py`` as an ``nn.Module``.

The reference's Cartesian form for l_max = 2, unchanged:
  l=0: scalar channels            (N, C)
  l=1: vector channels            (N, C, 3)
  l=2: traceless-symmetric 3x3    (N, C, 3, 3)
The A-features are ``index_add_`` scatters of the radial-weighted edge
tensors; the B-features b1-b6 are their invariant contractions up to
correlation order 3, so the energies are E(3)-invariant exactly.  The
energy head reads the scalars after every layer.  Radial basis: n_rbf
Bessel functions with a polynomial cutoff (p = 6).  No kernel runs.

``mix_v`` and ``mix_t`` are parameters that the forward never reads, as in
the reference (its ``forward`` keeps them "exercised" only in a comment):
their gradient is zero and weight decay still moves them
(``launch/steps.py`` gives a parameter without a gradient a zero one).

Under a ``ShardCtx`` (``sctx``) the radial MLPs and the edge tensors run on
this rank's edges (positions and channel-mixed features gathered by
``common``'s region), the moments A0-A2 scatter through its region into
node rows, and the energies are replicated.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ...devices import randn
from .common import (GraphBatch, GraphModel, gather, graph_readout,
                     init_linear, init_mlp2, mlp2, scatter_sum)
from .schnet import energy_mse


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128      # channels
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 10
    dtype: torch.dtype = torch.float32


def bessel_rbf(dist, n_rbf: int, cutoff: float):
    """MACE radial basis: sqrt(2/c) sin(n pi r / c) / r with the p = 6
    polynomial cutoff; n runs in f32 whatever the dtype."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=dist.device)
    d = torch.clamp(dist, min=1e-9)[:, None]
    rb = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d / cutoff) / d
    u = torch.clamp(dist / cutoff, 0.0, 1.0)
    f = 1 - 10 * u ** 3 + 15 * u ** 4 - 6 * u ** 5
    return rb * f[:, None]


def _traceless(m):
    # the trace as a masked sum: DTensor shards it by the rules of a
    # product and a sum, where torch 2.11 has none for the backward of
    # ``torch.diagonal``
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    tr = (m * eye).sum((-2, -1))
    return m - tr[..., None, None] / 3.0 * eye


def init_params(cfg: MACEConfig, generator: torch.Generator):
    """The reference's parameter shapes and scales, drawn from
    ``generator`` on its device: {"embed" (n_species, C), "layers":
    [{"R0", "R1", "R2", "mix_in", "w_b" (6, C), "update", "mix_v",
    "mix_t"}], "energy_head"}."""
    C = cfg.d_hidden
    dev = generator.device
    p = {"embed": randn((cfg.n_species, C), generator, cfg.dtype) * 0.1,
         "layers": []}
    for _ in range(cfg.n_layers):
        p["layers"].append({
            # radial weights for each output degree l = 0, 1, 2
            "R0": init_mlp2(generator, cfg.n_rbf, C, C, cfg.dtype),
            "R1": init_mlp2(generator, cfg.n_rbf, C, C, cfg.dtype),
            "R2": init_mlp2(generator, cfg.n_rbf, C, C, cfg.dtype),
            "mix_in": init_linear(generator, C, C, cfg.dtype, bias=False),
            # B-feature weights (correlation contractions -> scalars)
            "w_b": randn((6, C), generator, cfg.dtype) * 0.3,
            "update": init_mlp2(generator, C, C, C, cfg.dtype),
            # equivariant channel mixers, never read by the forward
            "mix_v": init_linear(generator, C, C, cfg.dtype, bias=False),
            "mix_t": init_linear(generator, C, C, cfg.dtype, bias=False),
        })
    p["energy_head"] = init_mlp2(generator, C, C, 1, cfg.dtype)
    return p


def _mix_channels(lin_p, x):
    """A channel-mixing linear along axis 1 of (N, C, ...)."""
    return torch.einsum("nc...,cd->nd...", x, lin_p["w"])


class MACE(GraphModel):
    """MACE on one device (see :class:`~.common.GraphModel`)."""
    init = staticmethod(init_params)

    def forward(self, batch: GraphBatch, sctx=None) -> torch.Tensor:
        """Per-graph energies (n_graphs,) in ``cfg.dtype``; equivariant
        internals."""
        cfg = self.cfg
        self._check_device(batch.positions)
        n = batch.n_nodes
        recv, mask = batch.receivers, batch.edge_mask
        h = gather(self["embed"].to(cfg.dtype), batch.species,
                   sctx)                                 # (N, C)
        ri = gather(batch.positions, recv, sctx)
        rj = gather(batch.positions, batch.senders, sctx)
        rel = (rj - ri).to(cfg.dtype)                            # (E, 3)
        dist = torch.sqrt(torch.clamp((rel ** 2).sum(-1), min=1e-12))
        unit = rel / dist[:, None]
        rbf = bessel_rbf(dist, cfg.n_rbf, cfg.cutoff).to(cfg.dtype)
        # edge angular tensors (Cartesian "spherical harmonics")
        y1 = unit                                                # (E, 3)
        y2 = _traceless(unit[:, :, None] * unit[:, None, :])     # (E, 3, 3)

        energies = None
        for lp in self["layers"]:
            hj = gather(_mix_channels(lp["mix_in"], h), batch.senders, sctx)
            r0 = mlp2(lp["R0"], rbf) * hj                        # (E, C)
            r1 = mlp2(lp["R1"], rbf) * hj
            r2 = mlp2(lp["R2"], rbf) * hj
            # A-features: aggregated equivariant moments
            A0 = scatter_sum(r0, recv, n, mask, sctx)            # (N, C)
            A1 = scatter_sum(r1[:, :, None] * y1[:, None, :], recv, n,
                             mask, sctx)                         # (N, C, 3)
            A2 = scatter_sum(r2[:, :, None, None] * y2[:, None, :, :], recv,
                             n, mask, sctx)                      # (N, C, 3, 3)
            # B-features: invariant contractions up to correlation order 3
            b1 = A0                                              # order 1
            b2 = (A1 * A1).sum(-1)                               # 1x1->0
            b3 = (A2 * A2).sum((-1, -2))                         # 2x2->0
            t11 = _traceless(A1[..., :, None] * A1[..., None, :])   # 1x1->2
            b4 = (t11 * A2).sum((-1, -2))                        # order 3
            b5 = A0 * b2                                         # order 3
            Qv = torch.einsum("ncij,ncj->nci", A2, A1)           # 2x1->1
            b6 = (Qv * A1).sum(-1)                               # order 3
            w_b = lp["w_b"]
            B = (w_b[0] * b1 + w_b[1] * b2 + w_b[2] * b3
                 + w_b[3] * b4 + w_b[4] * b5 + w_b[5] * b6)
            h = h + mlp2(lp["update"], B)                        # scalars
            e = mlp2(self["energy_head"], h)[:, 0]
            # the reference adds each layer's energies to zeros: 0 + e = e
            energies = e if energies is None else energies + e
        return graph_readout(energies, batch.graph_ids, batch.n_graphs,
                             batch.node_mask, op="sum", sctx=sctx)

    def loss_fn(self, batch: GraphBatch, sctx=None):
        """Mean squared error of the (n_graphs,) energies, in f32: (mse,
        {"mse": mse})."""
        return energy_mse(self(batch, sctx=sctx), batch.labels)
