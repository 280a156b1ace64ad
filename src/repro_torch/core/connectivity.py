"""Connected components in O(1) adaptive rounds (paper Theorem 1).

The paper obtains connectivity from MSF: compute any spanning forest, then
apply forest connectivity (Proposition 3.2).  The driver
(``repro_torch.ampc.solvers.cc_ampc``) runs the MSF pipeline on unit
weights and composes the two contraction maps; this module keeps the label
canonicalization it ends with, one phase of the MPC baseline (hash-to-min
label propagation, ``cc_mpc_hash_to_min``), and the batched solve's core,
the same propagation run to its fixpoint in one round
(``_cc_fixpoint_masked``).
"""
from __future__ import annotations

import numpy as np
import torch

from .rounds import host_read


def _canonicalize(labels: np.ndarray) -> np.ndarray:
    """Relabel components by their minimum vertex id (oracle convention).
    Label values may live in any id space (e.g. ternarized vertices)."""
    n = labels.shape[0]
    _, inv = np.unique(labels, return_inverse=True)
    rep = np.full(inv.max() + 1, n, np.int64)
    np.minimum.at(rep, inv, np.arange(n))
    return rep[inv]


def _h2m_phase(u, v, labels):
    """One hash-to-min phase: every endpoint and its current root take the
    edge's smaller label, then one shortcut.  ``u``/``v`` are int64.
    Returns (labels, changed as a device bool)."""
    lu, lv = labels[u], labels[v]
    mn = torch.minimum(lu, lv)
    new = labels.clone()
    for idx in (u, v, lu.long(), lv.long()):
        new.scatter_reduce_(0, idx, mn, "amin")
    new = new[new.long()]   # shortcut
    return new, (new != labels).any()


def _cc_fixpoint_masked(u, v, edge_ok, n: int, lanes: int = 1):
    """Connected-component labels by in-round min-label doubling.

    The core of the batched ``solve_many`` connectivity path: every
    hash-to-min phase runs against the same immutable snapshot inside one
    round.  ``u``/``v``/``edge_ok`` hold ``lanes`` offset-flattened graphs
    of ``n`` vertices each (lane b owns vertices ``[b*n, (b+1)*n)`` and the
    b-th equal share of the edges); ``edge_ok`` masks the padding edges.
    Labels are constant per component at the fixpoint (callers
    canonicalize).

    Returns (labels (lanes*n,) int32, iters, queries_nodedup,
    queries_dedup), the last three (lanes,) int64 device tensors.  A lane
    counts its waves up to and including its first wave without a change
    (a lane at its fixpoint stays there).  Query model: each wave, every
    live edge reads both endpoint labels (no-dedup count); with per-machine
    caching each distinct endpoint is fetched once per wave.
    """
    dev = u.device
    N = lanes * n
    u_l, v_l = u.long(), v.long()
    su = torch.where(edge_ok, u_l, N)
    sv = torch.where(edge_ok, v_l, N)
    scanned_per_wave = 2 * edge_ok.view(lanes, -1).sum(1)
    probe = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    probe[su] = 1
    probe[sv] = 1
    distinct_per_wave = probe[:N].view(lanes, n).sum(1)

    labels = torch.arange(N, dtype=torch.int32, device=dev)
    iters = torch.zeros(lanes, dtype=torch.int64, device=dev)
    live = torch.ones(lanes, dtype=torch.bool, device=dev)
    while True:
        lu, lv = labels[u_l], labels[v_l]
        mn = torch.minimum(lu, lv)
        # slot N is the drop slot of the masked edges
        new = torch.cat([labels, labels.new_zeros(1)])
        for idx in (su, sv, torch.where(edge_ok, lu.long(), N),
                    torch.where(edge_ok, lv.long(), N)):
            new.scatter_reduce_(0, idx, mn, "amin")
        new = new[:N]
        new = new[new.long()]   # shortcut
        iters += live
        live = (new != labels).view(lanes, n).any(1)
        labels = new
        if not host_read(live.any()):
            return (labels, iters, iters * scanned_per_wave,
                    iters * distinct_per_wave)
