"""Connected components in O(1) adaptive rounds (paper Theorem 1).

The paper obtains connectivity from MSF: compute any spanning forest, then
apply forest connectivity (Proposition 3.2).  The driver
(``repro_torch.ampc.solvers.cc_ampc``) runs the MSF pipeline on unit
weights and composes the two contraction maps; this module keeps the label
canonicalization it ends with.
"""
from __future__ import annotations

import numpy as np


def _canonicalize(labels: np.ndarray) -> np.ndarray:
    """Relabel components by their minimum vertex id (oracle convention).
    Label values may live in any id space (e.g. ternarized vertices)."""
    n = labels.shape[0]
    _, inv = np.unique(labels, return_inverse=True)
    rep = np.full(inv.max() + 1, n, np.int64)
    np.minimum.at(rep, inv, np.arange(n))
    return rep[inv]
