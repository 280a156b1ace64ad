"""Minimum spanning forest in constant adaptive rounds (paper Section 3).

Ports of the JAX package's ``repro.core.msf`` primitives:

  * ``truncated_prim``  — Algorithm 1: per-vertex rank-truncated Prim search
    (each vertex = one AMPC "machine task"); three stopping conditions
    (budget, exhaustion, lower-rank hook).
  * ``pointer_jump``    — Proposition 3.2 forest contraction (doubling).
  * ``contract_edges``  — relabel + self-loop removal + min-weight dedup.
  * ``boruvka_inround`` — DenseMSF stand-in: Borůvka hook-and-contract run
    to completion inside one round.
  * ``_mpc_boruvka_phase`` — one phase of the MPC red/blue Borůvka
    baseline (paper Section 5.5).

The reference runs each per-vertex ``while_loop`` under ``vmap``; here every
loop is one eager loop over all lanes in lockstep, with masked updates, which
is what ``vmap`` of a ``while_loop`` computes.  Each wave reads its loop
condition on the host once (counted in ``rounds.HOST_READS``).  Ties break as
in the reference: ``argmin`` takes the first minimum and the lexicographic
sort is stable.

A ``solve_many`` bucket runs through the same loops on its offset-flattened
lanes (lane b owns an equal range of vertices and edges): the waves of
disjoint graphs do not interact, and ``lanes=`` makes the per-lane
counters (doublings, phases, live vertices) equal their sequential
values.
"""
from __future__ import annotations

import torch

from .rounds import active_lanes, host_read

INF = float("inf")
INT32_MAX = 2**31 - 1


# --------------------------------------------------------------------------
# Algorithm 1: truncated Prim
# --------------------------------------------------------------------------
def truncated_prim_capped(nbr, nbw, nbe, rank, budget, capacity: int):
    """``truncated_prim`` with the buffer *capacity* decoupled from the
    stopping *budget* (``budget <= capacity``); extra slots stay at their
    -1/inf fill, so outputs equal ``truncated_prim``'s.  ``budget`` is an
    int, or an (n,) tensor of per-vertex budgets: a ``solve_many`` bucket
    gives each lane's vertices their own graph's budget under the bucket's
    shared capacity.

    The per-lane state (visited set, output slots, frontier) lives in
    (n, capacity) and (n, D * capacity) tensors updated in place; each wave
    touches only the lanes still running, and only the frontier columns a
    lane can have filled after that many waves (one add of D entries per
    wave at most; later columns hold inf and cannot win the argmin).
    """
    n, D = nbr.shape
    F = D * capacity  # frontier capacity
    dev = nbr.device
    lane_ids = torch.arange(n, dtype=torch.int32, device=dev)
    visited = torch.full((n, capacity), -1, dtype=torch.int32, device=dev)
    visited[:, 0] = lane_ids
    fdst = torch.full((n, F), -1, dtype=torch.int32, device=dev)
    fdst[:, :D] = nbr
    fw = torch.full((n, F), INF, dtype=torch.float32, device=dev)
    fw[:, :D] = nbw
    feid = torch.full((n, F), -1, dtype=torch.int32, device=dev)
    feid[:, :D] = nbe
    out = torch.full((n, capacity), -1, dtype=torch.int32, device=dev)
    vcount = torch.ones(n, dtype=torch.int64, device=dev)
    fsize = torch.full((n,), D, dtype=torch.int64, device=dev)
    ocount = torch.zeros(n, dtype=torch.int64, device=dev)
    hook = torch.full((n,), -1, dtype=torch.int32, device=dev)
    case = torch.zeros(n, dtype=torch.int32, device=dev)
    queries = torch.ones(n, dtype=torch.int32, device=dev)

    A = torch.arange(n, dtype=torch.int64, device=dev)
    wave = 0
    while A.numel():
        W = min(F, D * (wave + 1))
        Vw = min(capacity, wave + 1)
        fwA = fw[A, :W]
        idx = fwA.argmin(1)
        best_w = fwA.gather(1, idx[:, None]).squeeze(1)
        dst = fdst[A, idx]
        eid = feid[A, idx]
        exhausted = torch.isinf(best_w)
        # consume the frontier entry
        fw[A, idx] = INF
        fdst[A, idx] = -1
        already = (visited[A, :Vw] == dst[:, None]).any(1)
        dsafe = dst.clamp(0, n - 1).long()
        lower = rank[dsafe] < rank[A]
        go = ~exhausted & ~already
        is_hook = go & lower
        is_add = go & ~lower
        takes = is_hook | is_add  # both record the edge and pay a query

        oc = ocount[A]
        ocs = oc.clamp(max=capacity - 1)
        out[A, ocs] = torch.where(takes, eid, out[A, ocs])
        ocount[A] = oc + takes
        queries[A] += takes.to(torch.int32)
        hook[A] = torch.where(is_hook, dst, hook[A])

        vc = vcount[A]
        vcs = vc.clamp(max=capacity - 1)
        visited[A, vcs] = torch.where(is_add, dst, visited[A, vcs])
        pos = fsize[A]
        for j in range(D):
            col = (pos + j).clamp(max=F - 1)
            fdst[A, col] = torch.where(is_add, nbr[dsafe, j], fdst[A, col])
            fw[A, col] = torch.where(is_add, nbw[dsafe, j], fw[A, col])
            feid[A, col] = torch.where(is_add, nbe[dsafe, j], feid[A, col])
        vcount[A] = vc + is_add
        fsize[A] = pos + D * is_add

        bud = budget[A] if isinstance(budget, torch.Tensor) else budget
        new_case = torch.where(
            exhausted, 2, torch.where(
                is_hook, 3, torch.where(is_add & (vc + 1 >= bud), 1, 0)))
        case[A] = new_case.to(torch.int32)
        A = A[active_lanes(new_case == 0)]
        wave += 1
    return out, hook, case, queries


def truncated_prim(nbr, nbw, nbe, rank, budget: int):
    """Run rank-truncated Prim from every vertex of a Δ<=3 graph.

    nbr/nbw/nbe: (n, D) padded adjacency (ids / weights / edge ids),
    -1 / inf pad.
    rank: (n,) distinct float ranks (the random permutation π).
    Returns (out_eids (n, budget), hooks (n,), cases (n,), queries (n,)).
    cases: 1 = budget hit, 2 = component exhausted, 3 = lower-rank hook.
    """
    return truncated_prim_capped(nbr, nbw, nbe, rank, budget, budget)


# --------------------------------------------------------------------------
# Proposition 3.2: forest contraction by pointer jumping (in-round)
# --------------------------------------------------------------------------
def pointer_jump(parent: torch.Tensor, lanes=None):
    """Iterated doubling to the root; returns (roots, num_doublings).

    With ``lanes`` the forest is a ``solve_many`` bucket of that many
    equal vertex ranges, and ``num_doublings`` is an (lanes,) int64 tensor:
    each lane counts the doublings that moved one of its pointers, which
    is its own sequential count."""
    p = parent
    iters = 0 if lanes is None else torch.zeros(
        lanes, dtype=torch.int64, device=parent.device)
    while True:
        nxt = p[p.long()]
        moved = nxt != p
        if not host_read(moved.any()):
            return p, iters
        p = nxt
        iters = iters + (1 if lanes is None
                         else moved.view(lanes, -1).any(1))


# --------------------------------------------------------------------------
# Contraction: relabel edges, drop self-loops, dedup (min weight per pair)
# --------------------------------------------------------------------------
def contract_edges(u, v, w, eid, valid, labels, lanes=None):
    """Relabel endpoints by ``labels``; self-loops invalidated; duplicate
    (cu, cv) pairs keep only the minimum-weight edge. Shapes are static; a
    boolean ``valid`` mask tracks liveness.  Returns (cu, cv, w, eid, valid,
    n_live_vertices); with ``lanes`` (a ``solve_many`` bucket of equal
    label ranges) ``n_live_vertices`` is counted per lane."""
    cu = labels[u.long()]
    cv = labels[v.long()]
    lo = torch.minimum(cu, cv)
    hi = torch.maximum(cu, cv)
    valid = valid & (lo != hi)
    klo = torch.where(valid, lo, INT32_MAX)
    khi = torch.where(valid, hi, INT32_MAX)
    # lexicographic (klo, khi, w) order by stable sorts, least key first
    order = torch.sort(w, stable=True)[1]
    order = order[torch.sort(khi[order], stable=True)[1]]
    order = order[torch.sort(klo[order], stable=True)[1]]
    slo, shi = klo[order], khi[order]
    first = torch.ones_like(valid)
    first[1:] = (slo[1:] != slo[:-1]) | (shi[1:] != shi[:-1])
    keep = torch.zeros_like(valid)
    keep[order] = first
    keep &= valid
    # live vertex count: labels that appear as an endpoint of a live edge
    live = torch.zeros(labels.shape[0], dtype=torch.int32, device=u.device)
    k32 = keep.to(torch.int32)
    live.scatter_reduce_(0, torch.where(keep, lo, 0).long(), k32, "amax")
    live.scatter_reduce_(0, torch.where(keep, hi, 0).long(), k32, "amax")
    n_live = live.sum() if lanes is None else live.view(lanes, -1).sum(1)
    return cu, cv, w, eid, keep, n_live


# --------------------------------------------------------------------------
# DenseMSF stand-in: in-round Borůvka (min-edge hooking + doubling)
# --------------------------------------------------------------------------
def _component_min_edge(lu, lv, w, eid, valid, n):
    """For each component label, the (weight, lane)-lexicographic minimum
    incident cross edge.  Lanes (edge positions) are unique even when edge
    ids repeat (ternarization dummy edges all carry eid=-1), so the choice is
    unambiguous and two components hooking each other always agree on the
    same edge.  Returns (min_eid (n,), partner (n,), has (n,))."""
    E = w.shape[0]
    dev = w.device
    comp = torch.arange(n, dtype=torch.int32, device=dev)
    if E == 0:
        return (torch.full((n,), -1, dtype=torch.int32, device=dev), comp,
                torch.zeros(n, dtype=torch.bool, device=dev))
    cross = valid & (lu != lv)
    wbig = torch.where(cross, w, INF)
    both_l = torch.cat([lu, lv]).long()
    # segment minima: empty segments keep the dtype's identity
    seg_w = torch.full((n,), INF, dtype=w.dtype, device=dev)
    seg_w.scatter_reduce_(0, both_l, torch.cat([wbig, wbig]), "amin")
    lane = torch.arange(E, dtype=torch.int32, device=dev)
    big = 2**30
    lane_u = torch.where(cross & (w <= seg_w[lu.long()]), lane, big)
    lane_v = torch.where(cross & (w <= seg_w[lv.long()]), lane, big)
    seg_lane = torch.full((n,), INT32_MAX, dtype=torch.int32, device=dev)
    seg_lane.scatter_reduce_(0, both_l, torch.cat([lane_u, lane_v]), "amin")
    has = seg_lane < big
    sl = seg_lane.clamp(0, E - 1).long()
    min_eid = torch.where(has, eid[sl], -1)
    plu, plv = lu[sl], lv[sl]
    partner = torch.where(plu == comp, plv, plu)
    partner = torch.where(has, partner, comp)
    return min_eid, partner, has


def boruvka_core(u, v, w, eid, valid, n_labels: int, max_eid: int,
                 lanes=None):
    """Borůvka run to completion inside one round.

    Returns (msf_mask over [0, max_eid), labels, phases).  With ``lanes``
    the graph is a ``solve_many`` bucket of that many equal label ranges,
    and ``phases`` is an (lanes,) int64 tensor: a lane counts the phases
    up to and including its first phase without a hook, its sequential
    count (a lane without hooks keeps its labels from then on)."""
    n = n_labels
    dev = u.device
    labels0 = torch.arange(n, dtype=torch.int32, device=dev)
    labels = labels0
    mask = torch.zeros(max_eid, dtype=torch.bool, device=dev)
    u_l, v_l = u.long(), v.long()
    phases = 0
    if lanes is not None:
        lane_phases = torch.zeros(lanes, dtype=torch.int64, device=dev)
        done = torch.zeros(lanes, dtype=torch.bool, device=dev)
    while True:
        lu, lv = labels[u_l], labels[v_l]
        min_eid, partner, has = _component_min_edge(lu, lv, w, eid, valid, n)
        parent = torch.where(has, partner, labels0)
        # break 2-cycles: keep the hook only on the smaller label
        two = (parent[parent.long()] == labels0) & (parent != labels0)
        parent = torch.where(two & (labels0 > parent), labels0, parent)
        roots, _ = pointer_jump(parent)
        # an edge is selected if it was some component's min edge; invalid
        # lanes (no edge / dummy eid=-1) go to the drop slot max_eid
        sel = torch.where(has & (min_eid >= 0), min_eid, max_eid).long()
        selected = torch.zeros(max_eid + 1, dtype=torch.bool, device=dev)
        selected[sel] = True
        mask |= selected[:max_eid]
        labels = roots[labels.long()]
        phases += 1
        if lanes is not None:
            lane_phases += ~done
            done = ~has.view(lanes, -1).any(1)
        if not host_read(has.any()):
            return mask, labels, (phases if lanes is None else lane_phases)


boruvka_inround = boruvka_core


# --------------------------------------------------------------------------
# MPC baseline: red/blue Borůvka, 3 shuffles per phase (paper Section 5.5)
# --------------------------------------------------------------------------
def _mpc_boruvka_phase(u, v, w, eid, valid, labels, color, max_eid: int):
    """One red/blue Borůvka phase: each *blue* component computes its
    minimum incident cross edge and contracts into the partner only if the
    partner is *red*.  Returns (labels, selected (max_eid,) bool, valid,
    remaining valid edges as a device scalar)."""
    n = labels.shape[0]
    u_l, v_l = u.long(), v.long()
    lu, lv = labels[u_l], labels[v_l]
    min_eid, partner, has = _component_min_edge(lu, lv, w, eid, valid, n)
    ids = torch.arange(n, dtype=torch.int32, device=u.device)
    hook = has & color & ~color[partner.long()]   # I am blue, partner red
    parent = torch.where(hook, partner, ids)      # depth 1, acyclic
    sel = torch.where(hook & (min_eid >= 0), min_eid, max_eid).long()
    selected = torch.zeros(max_eid + 1, dtype=torch.bool, device=u.device)
    selected[sel] = True
    labels = parent[labels.long()]
    new_valid = valid & (labels[u_l] != labels[v_l])
    return labels, selected[:max_eid], new_valid, new_valid.sum()
