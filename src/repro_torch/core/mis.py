"""Maximal independent set (paper Proposition 4.2 / Section 5.3), torch.

The AMPC algorithm computes the *lexicographically-first MIS* over a random
vertex permutation π: a vertex joins when all lower-rank neighbours are
OUT; a vertex is OUT when a neighbour is IN.  Every wave reads the same
immutable snapshot, so the whole fixpoint is one AMPC round.  This is the
port of the JAX package's ``repro.core.mis`` fixpoint: one eager loop whose
condition is read on the host once per wave (``rounds.HOST_READS``).
"""
from __future__ import annotations

import torch

from .rounds import host_read

UNKNOWN, IN, OUT = 0, 1, 2
INT32_MIN = -2**31


def _segment_any(flags: torch.Tensor, segments: torch.Tensor, n: int):
    """``segment_max`` of 0/1 flags; empty segments hold int32's minimum."""
    out = torch.full((n,), INT32_MIN, dtype=torch.int32, device=flags.device)
    return out.scatter_reduce_(0, segments, flags.to(torch.int32), "amax")


def _mis_wave(status, s_l, r_l, lower, edge_ok, n: int):
    """One wave: an undecided vertex with an IN neighbour goes OUT; one
    whose lower-rank neighbours are all OUT goes IN.  Returns (status,
    s_unk: the edges whose sender was undecided)."""
    st_r = status[r_l]
    s_unk = (status[s_l] == UNKNOWN) & edge_ok
    # does sender have any lower-rank neighbour that is not OUT?
    has_block = _segment_any(s_unk & lower & (st_r != OUT), s_l, n)
    has_in = _segment_any(s_unk & (st_r == IN), s_l, n)
    unk = status == UNKNOWN
    status = torch.where(unk & (has_in > 0), OUT, status)
    status = torch.where(unk & (has_in <= 0) & (has_block <= 0), IN, status)
    return status, s_unk


def _mis_fixpoint_masked(senders, receivers, rank, n: int, edge_ok):
    """LFMIS fixpoint with an edge-validity mask.

    ``edge_ok`` marks the real directed edges; masked lanes never
    contribute to blocking, joining, or query counts.

    Returns (status(n,) int32, iters, queries_nodedup, queries_dedup).
    Query accounting per wave: every undecided vertex fetches the status of
    each of its neighbours (no-dedup count); with caching each *distinct*
    neighbour is fetched once per machine — the per-wave dedup is one fetch
    per distinct queried vertex (paper Section 5.3).  ``iters`` is a host
    int; the two query counts are int64 device scalars.
    """
    dev = senders.device
    s_l, r_l = senders.long(), receivers.long()
    lower = rank[r_l] < rank[s_l]  # the snapshot never changes
    status = torch.zeros(n, dtype=torch.int32, device=dev)
    iters = 0
    q0 = torch.zeros((), dtype=torch.int64, device=dev)
    q1 = torch.zeros((), dtype=torch.int64, device=dev)
    while host_read((status == UNKNOWN).any()):
        status, s_unk = _mis_wave(status, s_l, r_l, lower, edge_ok, n)
        # queries: edges scanned this wave (sender undecided)
        q0 += s_unk.sum()
        # dedup: distinct receivers queried this wave (slot n drops)
        probe = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        probe[torch.where(s_unk, r_l, n)] = 1
        q1 += probe[:n].sum()
        iters += 1
    return status, iters, q0, q1


def _mis_fixpoint(senders, receivers, rank, n: int):
    """Run the LFMIS fixpoint to completion (every edge lane valid).
    Returns (status(n,), iters, queries_nodedup, queries_dedup)."""
    return _mis_fixpoint_masked(
        senders, receivers, rank, n,
        torch.ones(senders.shape, dtype=torch.bool, device=senders.device))
