"""1-vs-2-Cycle (paper Section 5.6), torch: the AMPC-vs-MPC separation.

AMPC: sample vertices with probability p; each sampled vertex *walks* the
cycle in both directions by adaptive pointer chasing inside a single round
until it meets the next sampled vertex; the contracted cycle over the
samples is then resolved by in-round hook-and-contract.  One shuffle writes
the graph to the DHT; one launch answers.

MPC baseline: CC-LocalContraction, one materialized phase at a time.

The port of the JAX package's ``repro.core.one_vs_two``.  The reference
walks all n lanes and masks the unsampled ones out of every output; the
port walks the sampled lanes alone, as one eager loop over the lanes still
walking, with one host read a wave (``rounds.HOST_READS``).  Each lane
stops at the step the reference's does.  As in the reference, the walk and
the count go through ``runtime.retry.resilient_call``.  A ``solve_many``
bucket walks its offset-flattened graphs in one loop (``lanes=``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.coo import UGraph
from ..runtime.retry import resilient_call
from .msf import boruvka_core
from .rounds import active_lanes


def cycle_adjacency(g: UGraph) -> np.ndarray:
    """(n, 2) int32 neighbour table of a disjoint union of cycles.

    Equal to the reference's loop, which appends ``b`` to ``a``'s row and
    then ``a`` to ``b``'s for each edge (a, b) in edge order: the arcs
    (a, b), (b, a) interleaved in edge order, stably sorted by their first
    vertex, two to a vertex."""
    if not (g.degrees() == 2).all():
        raise ValueError("1-vs-2-cycle input must be a union of cycles "
                         "(every vertex of degree 2)")
    src = g.edges.reshape(-1)           # a0, b0, a1, b1, ...
    dst = g.edges[:, ::-1].reshape(-1)  # b0, a0, b1, a1, ...
    order = np.argsort(src, kind="stable")
    return np.ascontiguousarray(dst[order].reshape(g.n, 2), dtype=np.int32)


def _walk(nbr, sampled, max_steps: int):
    """Every sampled vertex walks outward in both directions until the next
    sampled vertex, or until ``max_steps`` steps.

    Returns (lanes (k,) int64 sampled vertex ids, succ (2, k) int32 with -1
    where a walk did not arrive, steps (2, k) int64, done (2, k) bool), one
    row per direction, in vertex order.
    """
    dev = nbr.device
    lanes = torch.nonzero(sampled).squeeze(1)
    k = lanes.numel()
    nbr_l = nbr.long()
    prev = lanes.repeat(2)
    cur = torch.cat([nbr_l[lanes, 0], nbr_l[lanes, 1]])
    steps = torch.ones(2 * k, dtype=torch.int64, device=dev)
    done = sampled[cur]
    A = active_lanes(~done & (steps < max_steps))
    while A.numel():
        p, c = prev[A], cur[A]
        n0, n1 = nbr_l[c, 0], nbr_l[c, 1]
        nxt = torch.where(n0 == p, n1, n0)
        prev[A] = c
        cur[A] = nxt
        steps[A] += 1
        d = sampled[nxt]
        done[A] = d
        A = A[active_lanes(~d & (steps[A] < max_steps))]
    succ = torch.where(done, cur, -1).to(torch.int32)
    return lanes, succ.view(2, k), steps.view(2, k), done.view(2, k)


def _count_components(succ0, succ1, sampled, n: int, lanes=None):
    """Components of the contracted graph: arcs (v, succ[v]) per direction
    for the samples, resolved by in-round hook-and-contract; the count of
    distinct labels among the samples (int64 device scalar; per lane, an
    (lanes,) tensor, when ``lanes`` equal vertex ranges share the call).
    ``succ0`` and ``succ1`` are (n,), -1 where no walk arrived."""
    dev = sampled.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    u_c = torch.cat([ids, ids])
    v_c = torch.cat([torch.where(sampled & (succ0 >= 0), succ0, ids),
                     torch.where(sampled & (succ1 >= 0), succ1, ids)])
    valid = torch.cat([sampled, sampled]) & (u_c != v_c)
    w_c = torch.arange(2 * n, dtype=torch.float32, device=dev)
    eid_c = torch.arange(2 * n, dtype=torch.int32, device=dev)
    _, labels, _ = boruvka_core(u_c, v_c, w_c, eid_c, valid, n, 2 * n)
    seen = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    seen[torch.where(sampled, labels, n).long()] = 1
    return seen[:n].sum() if lanes is None else seen[:n].view(
        lanes, -1).sum(1)


def _walk_and_count(nbr, sampled, max_steps: int, lanes=None):
    """Walk from the samples, then count components.  Returns (ncomp,
    total_steps, ok) as device scalars; with ``lanes`` (a ``solve_many``
    bucket of that many offset-flattened graphs of equal vertex ranges) as
    (lanes,) tensors, one entry a graph."""
    n = nbr.shape[0]
    ids, succ, steps, done = resilient_call(_walk, nbr, sampled, max_steps)
    full = torch.full((2, n), -1, dtype=torch.int32, device=nbr.device)
    full[:, ids] = succ
    ncomp = resilient_call(_count_components, full[0], full[1], sampled, n,
                           lanes)
    if lanes is None:
        return ncomp, steps.sum(), done.all()
    lane = ids // (n // lanes)
    total = torch.zeros(lanes, dtype=torch.int64, device=nbr.device)
    total.index_add_(0, lane, steps.sum(0))
    missed = torch.zeros(lanes, dtype=torch.int64, device=nbr.device)
    missed.index_add_(0, lane, (~done).sum(0))
    return ncomp, total, missed == 0


def _local_contraction_phase(a, b, parent, alive, rank):
    """One CC-LocalContraction phase: remove rank-local-minima, reconnect
    their neighbours.  Self-loop vertices (a == b == self) are finished
    cycles.  Returns (a, b, parent, alive, remaining as a device scalar)."""
    n = a.shape[0]
    ids = torch.arange(n, dtype=a.dtype, device=a.device)
    al, bl = a.long(), b.long()
    finished = (a == ids) & (b == ids)
    act = alive & ~finished
    is_min = act & (rank < rank[al]) & (rank < rank[bl])
    # 2-cycles (a == b != self): the smaller-rank endpoint is the local min
    two = act & (a == b) & (a != ids)
    is_min = torch.where(two, act & (rank < rank[al]), is_min)

    def other(x):
        """The neighbour of x that is not the vertex looking (for 2-cycles
        the looker itself, collapsing to a self-loop)."""
        return torch.where(a[x] == ids, b[x], a[x])

    # surviving vertices repoint through removed neighbours
    new_a = torch.where(is_min[al], other(al), a)
    new_b = torch.where(is_min[bl], other(bl), b)
    # removed vertices remember a surviving neighbour for label recovery
    parent = torch.where(is_min, a, parent)
    # removed vertices become inert self-loops
    new_a = torch.where(is_min, ids, new_a)
    new_b = torch.where(is_min, ids, new_b)
    alive = alive & ~is_min
    remaining = (alive & ~((new_a == ids) & (new_b == ids))).sum()
    return new_a, new_b, parent, alive, remaining
