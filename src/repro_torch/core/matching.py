"""Maximal matching (paper Section 4, Theorem 2), torch.

Every variant computes the exact random-greedy (lexicographically-first)
maximal matching over a random edge permutation π: an edge joins when it is
the minimum-rank unresolved edge at *both* endpoints, and dies when an
endpoint is matched.  This is the port of the JAX package's
``repro.core.matching`` fixpoint (``_mm_wave``, ``_mm_fixpoint``): one eager
loop whose condition is read on the host once per wave
(``rounds.HOST_READS``), over one graph or over a ``solve_many`` bucket's
offset-flattened lanes (``_mm_fixpoint_lanes``).  The drivers live in
``repro_torch.ampc.solvers``.
"""
from __future__ import annotations

import torch

from .rounds import host_read

UNKNOWN, IN, OUT = 0, 1, 2
INF = float("inf")


def _mark(n: int, mask, u, v, base=None):
    """(n,) int32 flags: 1 at both endpoints of every ``mask`` edge (on top
    of ``base``); slot n is the drop slot for the other lanes."""
    flags = torch.zeros(n + 1, dtype=torch.int32, device=u.device)
    if base is not None:
        flags[:n] = base
    flags[torch.where(mask, u, n)] = 1
    flags[torch.where(mask, v, n)] = 1
    return flags[:n]


def _mm_wave(estatus, u, v, erank, n: int, active_edge=None):
    """One fixpoint wave.  ``u``/``v`` are int64 endpoint indices.  Returns
    (new_estatus, matched (n,) int32)."""
    unk = estatus == UNKNOWN
    # endpoints already matched by earlier waves: their edges never join
    pmatch = _mark(n, estatus == IN, u, v)
    wbig = torch.where(unk, erank, INF)
    # segment minimum; a vertex without an unresolved edge reads +inf
    vmin = torch.full((n,), INF, dtype=erank.dtype, device=erank.device)
    vmin.scatter_reduce_(0, torch.cat([u, v]), torch.cat([wbig, wbig]),
                         "amin")
    is_min = (unk & (pmatch[u] == 0) & (pmatch[v] == 0)
              & (erank <= vmin[u]) & (erank <= vmin[v]))
    if active_edge is not None:
        is_min &= active_edge
    new = torch.where(is_min, IN, estatus)
    matched = _mark(n, is_min, u, v, base=pmatch)
    die = (new == UNKNOWN) & ((matched[u] == 1) | (matched[v] == 1))
    if active_edge is not None:
        die &= active_edge
    return torch.where(die, OUT, new), matched


def _mm_fixpoint_lanes(u, v, erank, n: int, lanes: int, estatus0):
    """LFMM fixpoint over ``lanes`` disjoint graphs of ``n`` vertices.

    Lane b owns vertices ``[b*n, (b+1)*n)`` and the b-th equal share of
    the edges (a ``solve_many`` bucket, offset-flattened; one graph is
    ``lanes=1``).  Padding edges start OUT, so they never join, block or
    count.  One host read a wave serves every lane.

    Returns (estatus (lanes*m_lane,) int32, waves, iters, queries_nodedup,
    queries_dedup): ``waves`` is a host int, the rest (lanes,) int64
    device tensors.  A lane counts the waves in which it had an unresolved
    edge, as the reference's ``it + live`` counts.  Per wave, each
    unresolved edge probes both endpoint frontiers (no-dedup count); with
    caching each distinct probed vertex is fetched once."""
    dev = u.device
    N = lanes * n
    u, v = u.long(), v.long()
    estatus = estatus0
    waves = 0
    iters, q0, q1 = (torch.zeros(lanes, dtype=torch.int64, device=dev)
                     for _ in range(3))
    while host_read((estatus == UNKNOWN).any()):
        unk = estatus == UNKNOWN
        estatus, _ = _mm_wave(estatus, u, v, erank, N)
        by_lane = unk.view(lanes, -1)
        iters += by_lane.any(1)
        q0 += 2 * by_lane.sum(1)
        q1 += _mark(N, unk, u, v).view(lanes, n).sum(1)
        waves += 1
    return estatus, waves, iters, q0, q1


def _mm_fixpoint(u, v, erank, n: int, estatus0):
    """Run the LFMM fixpoint on one graph to completion.

    Returns (estatus (m,) int32, iters, queries_nodedup, queries_dedup):
    ``iters`` is a host int, the query counts int64 device scalars (see
    :func:`_mm_fixpoint_lanes`)."""
    estatus, waves, _, q0, q1 = _mm_fixpoint_lanes(u, v, erank, n, 1,
                                                   estatus0)
    return estatus, waves, q0[0], q1[0]
