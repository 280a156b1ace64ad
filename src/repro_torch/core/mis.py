"""Maximal independent set (paper Proposition 4.2 / Section 5.3), torch.

The AMPC algorithm computes the *lexicographically-first MIS* over a random
vertex permutation π: a vertex joins when all lower-rank neighbours are
OUT; a vertex is OUT when a neighbour is IN.  Every wave reads the same
immutable snapshot, so the whole fixpoint is one AMPC round.  This is the
port of the JAX package's ``repro.core.mis`` fixpoint: one eager loop whose
condition is read on the host once per wave (``rounds.HOST_READS``), over
one graph or over a ``solve_many`` bucket's offset-flattened lanes.
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


def _mis_fixpoint_lanes(senders, receivers, rank, n: int, lanes: int,
                        edge_ok):
    """LFMIS fixpoint over ``lanes`` disjoint graphs of ``n`` vertices.

    Lane b owns vertices ``[b*n, (b+1)*n)`` and the b-th equal share of
    the directed edges (a ``solve_many`` bucket, offset-flattened; one
    graph is ``lanes=1``).  ``edge_ok`` marks the real directed edges;
    masked lanes never contribute to blocking, joining, or query counts,
    so each lane follows the trajectory of its own sequential fixpoint,
    and one host read a wave serves every lane.

    Returns (status (lanes*n,) int32, waves, iters, queries_nodedup,
    queries_dedup): ``waves`` is a host int, the rest (lanes,) int64
    device tensors.  A lane counts the waves in which it had an undecided
    vertex.  Query accounting per wave: every undecided vertex fetches the
    status of each of its neighbours (no-dedup count); with caching each
    *distinct* neighbour is fetched once per machine — the per-wave dedup
    is one fetch per distinct queried vertex (paper Section 5.3).
    """
    dev = senders.device
    N = lanes * n
    s_l, r_l = senders.long(), receivers.long()
    lower = rank[r_l] < rank[s_l]  # the snapshot never changes
    status = torch.zeros(N, dtype=torch.int32, device=dev)
    waves = 0
    iters, q0, q1 = (torch.zeros(lanes, dtype=torch.int64, device=dev)
                     for _ in range(3))
    while host_read((status == UNKNOWN).any()):
        iters += (status.view(lanes, n) == UNKNOWN).any(1)
        status, s_unk = _mis_wave(status, s_l, r_l, lower, edge_ok, N)
        # queries: edges scanned this wave (sender undecided)
        q0 += s_unk.view(lanes, -1).sum(1)
        # dedup: distinct receivers queried this wave (slot N drops)
        probe = torch.zeros(N + 1, dtype=torch.int32, device=dev)
        probe[torch.where(s_unk, r_l, N)] = 1
        q1 += probe[:N].view(lanes, n).sum(1)
        waves += 1
    return status, waves, iters, q0, q1


def _mis_fixpoint(senders, receivers, rank, n: int):
    """Run the LFMIS fixpoint on one graph (every edge lane valid).
    Returns (status(n,), iters as a host int, queries_nodedup,
    queries_dedup as int64 device scalars)."""
    status, waves, _, q0, q1 = _mis_fixpoint_lanes(
        senders, receivers, rank, n, 1,
        torch.ones(senders.shape, dtype=torch.bool, device=senders.device))
    return status, waves, q0[0], q1[0]
