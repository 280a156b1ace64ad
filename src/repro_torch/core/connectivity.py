"""Connected components in O(1) adaptive rounds (paper Theorem 1).

The paper obtains connectivity from MSF: compute any spanning forest, then
apply forest connectivity (Proposition 3.2).  The driver
(``repro_torch.ampc.solvers.cc_ampc``) runs the MSF pipeline on unit
weights and composes the two contraction maps; this module keeps the label
canonicalization it ends with, and one phase of the MPC baseline
(hash-to-min label propagation, ``cc_mpc_hash_to_min``).
"""
from __future__ import annotations

import numpy as np
import torch


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
