"""AMPC and MPC solver drivers — the engine's algorithm layer (torch port).

Ports of every driver of the JAX package's ``repro.ampc.solvers`` (MIS,
the matching family, MSF with its KKT filter, connectivity, 1-vs-2-cycle,
and the MPC baselines), with the snapshot paths ``GraphSession`` solves
take, registered with :mod:`repro_torch.ampc.registry` so
``AmpcEngine.solve`` reaches them, and the seven ``@batched_impl``
adapters behind ``AmpcEngine.solve_many`` (bottom of this module).  The
host-side steps (graph layout, ternarization, every draw from
``np.random.default_rng(seed)``, in the same order) are the reference's, so
outputs, stats and ledger counters equal the reference's for the same graph
and seed.  The MPC baselines read their loop condition on the host once a
phase (``rounds.HOST_READS``), as the reference does.

The ``dht`` parameter realizes the paper's last step of every AMPC round:
machines read their outputs back from the immutable DHT snapshot
(CollectOutputs).  Every tensor lives on ``device``; each solve ends in one
``RoundLedger.harvest``.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import matching
from ..core.connectivity import (_canonicalize, _cc_fixpoint_masked,
                                 _h2m_phase)
from ..core.mis import (IN, UNKNOWN, _mis_fixpoint, _mis_fixpoint_lanes,
                        _mis_wave)
from ..core.msf import (_mpc_boruvka_phase, boruvka_core, boruvka_inround,
                        contract_edges, pointer_jump, truncated_prim,
                        truncated_prim_capped)
from ..core.one_vs_two import (_local_contraction_phase, _walk_and_count,
                               cycle_adjacency)
from ..core.rounds import RoundLedger, harvest_many, host_read, nbytes_of
from ..core.ternarize import ternarize, ternarize_batch
from ..graph.coo import UGraph
from .registry import batched_impl, problem


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _collect_dev(dht, ledger, values, keys=None, dedup: bool = False):
    """CollectOutputs: read an output snapshot back through the DHT backend.

    ``dht=None`` returns the tensor unchanged.  With a backend, the read is
    a genuine lookup whose queries/bytes land in the ledger.  The result
    stays on the device: the caller materializes it through the solve's
    single :meth:`RoundLedger.harvest`.
    """
    if dht is None:
        return values
    if keys is None:
        keys = torch.arange(values.shape[0], dtype=torch.int32,
                            device=values.device)
    return dht.lookup(values, keys, ledger=ledger, dedup=dedup)


# ==========================================================================
# MIS (paper Proposition 4.2 / Section 5.3)
# ==========================================================================
def mis_ampc(g: UGraph, seed: int = 0,
             ledger: Optional[RoundLedger] = None,
             caching: bool = True, dht=None, snapshot=None,
             device="cuda") -> Tuple[np.ndarray, dict]:
    """Returns (in_mis bool(n,), stats).

    ``snapshot`` (a :class:`~repro_torch.ampc.session.GraphSnapshot`)
    replaces shuffle 1 with a read of the session's cached graph-KV image:
    cold it records one ``WriteGraphKV`` shuffle, warm it records none —
    the rank permutation is still drawn per solve, so outputs equal the
    snapshot-free path's.
    """
    ledger = ledger if ledger is not None else RoundLedger("ampc_mis")
    n = g.n
    rng = np.random.default_rng(seed)
    rank = rng.permutation(n).astype(np.float32)

    snap_stat = None
    if snapshot is not None:
        entries, snap_hit = snapshot.materialize(ledger)
        senders = entries["sym_senders"]
        receivers = entries["sym_receivers"]
        jrank = _to(rank, device)
        snap_stat = snapshot.stat(snap_hit)
    else:
        # shuffle 1: build the rank-directed graph, write to the DHT
        # (Fig 1 step 1-2)
        with ledger.shuffle("DirectEdges+WriteKV", nbytes_of(g.edges) * 2):
            s, r, _, _ = g.symmetric()
            senders, receivers = _to(s, device), _to(r, device)
            jrank = _to(rank, device)

    # shuffle 2: IsInMIS search — adaptive queries against the snapshot
    with ledger.shuffle("IsInMIS", n * 4):
        status_dev, it, q0, q1 = _mis_fixpoint(senders, receivers, jrank, n)
        out_dev = _collect_dev(dht, ledger, status_dev)
        # the solve's one transfer: outputs + every deferred counter record
        status, qn, qd = ledger.harvest((out_dev, q0, q1))
        qn, qd = int(qn), int(qd)
    queries = qd if caching else qn
    row_bytes = 8  # nodeid + status
    ledger.record_queries(queries, queries * row_bytes, waves=it,
                          deduped_away=(qn - qd) if caching else 0)
    if (status == UNKNOWN).any():
        raise RuntimeError("MIS fixpoint left undecided vertices")
    stats = {"fixpoint_iters": it, "queries_nodedup": qn,
             "queries_dedup": qd,
             "cache_savings_factor": qn / max(qd, 1)}
    if snap_stat is not None:
        stats["snapshot"] = snap_stat
    return status == IN, stats


def mis_mpc_rootset(g: UGraph, seed: int = 0,
                    ledger: Optional[RoundLedger] = None,
                    max_phases: int = 500,
                    device="cuda") -> Tuple[np.ndarray, dict]:
    """MPC rootset baseline (paper Fig 2): one MIS wave a phase, two
    shuffles a phase.  Returns (in_mis bool(n,), stats)."""
    ledger = ledger if ledger is not None else RoundLedger("mpc_mis")
    n = g.n
    rng = np.random.default_rng(seed)
    rank = _to(rng.permutation(n).astype(np.float32), device)
    s, r, _, _ = g.symmetric()
    s_l, r_l = _to(s, device).long(), _to(r, device).long()
    lower = rank[r_l] < rank[s_l]
    edge_ok = torch.ones(s_l.shape, dtype=torch.bool, device=device)
    status = torch.zeros(n, dtype=torch.int32, device=device)
    phases = 0
    nb = nbytes_of(g.edges) * 2
    remaining = n
    while remaining > 0 and phases < max_phases:
        # paper Fig 2: 2 shuffles per phase (mark-to-remove join, removal
        # join)
        with ledger.shuffle(f"rootset_mark_{phases}", nb):
            status, _ = _mis_wave(status, s_l, r_l, lower, edge_ok, n)
        with ledger.shuffle(f"rootset_remove_{phases}", nb):
            remaining = host_read((status == UNKNOWN).sum())
        phases += 1
    status = ledger.harvest(status)
    return status == IN, {"phases": phases}


# ==========================================================================
# Maximal matching (paper Section 4, Theorem 2)
# ==========================================================================
def _edge_ends(g: UGraph, device):
    """The edges' endpoints on the device, as int64 index tensors."""
    return _to(g.edges[:, 0], device).long(), _to(g.edges[:, 1],
                                                   device).long()


def mm_ampc(g: UGraph, seed: int = 0,
            ledger: Optional[RoundLedger] = None,
            caching: bool = True, erank: Optional[np.ndarray] = None,
            dht=None, snapshot=None,
            device="cuda") -> Tuple[np.ndarray, dict]:
    """Greedy maximal matching over the rank permutation ``erank``.

    ``erank`` is the rank-injection point (Corollary 4.1): when omitted it
    is a fresh random permutation drawn from ``seed``; weighted matching
    passes decreasing-weight ranks instead.  ``snapshot`` reuses a
    session's cached graph-KV image in place of the ``SortEdges+WriteKV``
    shuffle (see :func:`mis_ampc`).  Returns (in_mm bool(m,), stats).
    """
    ledger = ledger if ledger is not None else RoundLedger("ampc_mm")
    n, m = g.n, g.m
    if erank is None:
        rng = np.random.default_rng(seed)
        erank = rng.permutation(m).astype(np.float32)
    else:
        erank = np.asarray(erank, np.float32)
        if erank.shape != (m,):
            raise ValueError("erank must be one rank per edge")

    snap_stat = None
    if snapshot is not None:
        entries, snap_hit = snapshot.materialize(ledger)
        u, v = entries["edge_u"], entries["edge_v"]
        jrank = _to(erank, device)
        snap_stat = snapshot.stat(snap_hit)
    else:
        with ledger.shuffle("SortEdges+WriteKV", nbytes_of(g.edges) * 2):
            u, v = _edge_ends(g, device)
            jrank = _to(erank, device)

    with ledger.shuffle("IsInMM", m):
        estatus_dev, it, q0, q1 = matching._mm_fixpoint(
            u, v, jrank, n, torch.zeros(m, dtype=torch.int32, device=device))
        out_dev = _collect_dev(dht, ledger, estatus_dev)
        estatus, qn, qd = ledger.harvest((out_dev, q0, q1))
        qn, qd = int(qn), int(qd)
    queries = qd if caching else qn
    ledger.record_queries(queries, queries * 12, waves=it,
                          deduped_away=(qn - qd) if caching else 0)
    stats = {"fixpoint_iters": it, "queries_nodedup": qn,
             "queries_dedup": qd, "erank": erank}
    if snap_stat is not None:
        stats["snapshot"] = snap_stat
    return estatus == IN, stats


def mm_ampc_levels(g: UGraph, seed: int = 0,
                   ledger: Optional[RoundLedger] = None,
                   device="cuda") -> Tuple[np.ndarray, dict]:
    """Algorithm 4: O(log log Δ) geometric sampling levels, one launch a
    level (at most k, from the graph's maximum degree)."""
    ledger = ledger if ledger is not None else RoundLedger("ampc_mm_levels")
    n, m = g.n, g.m
    rng = np.random.default_rng(seed)
    erank01 = rng.permutation(m).astype(np.float64) / max(m, 1)  # in [0,1)
    delta = int(g.degrees().max()) if m else 1
    k = int(np.ceil(np.log2(max(np.log2(max(delta, 2)), 1.000001)))) + 1
    u, v = _edge_ends(g, device)
    jrank = _to(erank01.astype(np.float32), device)
    rank01 = _to(erank01, device)
    estatus = torch.zeros(m, dtype=torch.int32, device=device)
    level_stats = []
    ten_log_n = 10 * np.log(max(n, 2))
    for i in range(1, k + 1):
        # current maximum degree of the residual graph
        unk = estatus == UNKNOWN
        cur_delta = 0
        if m:
            deg = torch.zeros(n, dtype=torch.int64, device=device)
            for end in (u, v):
                deg.scatter_add_(0, end, unk.long())
            cur_delta = host_read(deg.max())
        if cur_delta == 0:
            break
        if cur_delta > ten_log_n:
            thresh = float(delta) ** (-(0.5 ** i))
        else:
            thresh = 1.1  # H_i = G_i
        in_h = (rank01 <= thresh) & unk
        with ledger.shuffle(f"level_{i}_greedyMM", nbytes_of(g.edges)):
            # resolve the sampled subgraph completely (one AMPC launch)
            st, iters, _, _ = matching._mm_fixpoint(
                u, v, torch.where(in_h, jrank, matching.INF), n,
                torch.where(in_h, UNKNOWN, matching.OUT).to(torch.int32))
            # edges of H_i resolved; commit IN edges, kill touched vertices
            estatus = torch.where((st == IN) & in_h, IN, estatus)
            matched = matching._mark(n, estatus == IN, u, v)
            dead = (estatus == UNKNOWN) & ((matched[u] == 1)
                                           | (matched[v] == 1))
            estatus = torch.where(dead, matching.OUT, estatus)
            # H_i \ M_i edges whose endpoints survive go back to G_{i+1}
        level_stats.append({"level": i, "delta": cur_delta,
                            "threshold": thresh, "iters": iters})
    st = ledger.harvest(estatus)
    return st == IN, {"levels": level_stats, "k": k,
                      "erank": erank01.astype(np.float32)}


def _vertex_launch(estatus, u, v, jrank, n: int, budget: int):
    """One launch of the vertex process: every vertex has ``budget``
    queries; an edge is decided only while an endpoint has budget left, and
    the launch stops when no such edge is unresolved or after
    4 * budget waves.  Returns (estatus, queries as a device scalar)."""
    dev = u.device
    qcount = torch.zeros(n, dtype=torch.int32, device=dev)
    q = torch.zeros((), dtype=torch.int64, device=dev)
    it = 0
    while it < 4 * budget:
        active = (qcount[u] < budget) | (qcount[v] < budget)
        live = (estatus == UNKNOWN) & active
        if not host_read(live.any()):
            break
        estatus, _ = matching._mm_wave(estatus, u, v, jrank, n,
                                       active_edge=active)
        # each unresolved active edge costs one query at each endpoint
        # (every edge adds its 0 or 1 at its own endpoints: no one address
        # takes the atomics of all the other edges)
        cost = live.to(torch.int32)
        for end in (u, v):
            qcount.scatter_add_(0, end, cost)
        q += live.sum()
        it += 1
    return estatus, q


def mm_ampc_vertex_process(g: UGraph, epsilon: float = 0.5, seed: int = 0,
                           ledger: Optional[RoundLedger] = None,
                           device="cuda") -> Tuple[np.ndarray, dict]:
    """Theorem 2 part 2: vertex-started truncated query process.

    Each launch gives every vertex a fresh budget of n^ε queries; decisions
    on an edge are applied only while at least one endpoint still has
    budget, so resolution is delayed — never altered — and the output is
    the exact LFMM (at most 64 launches).
    """
    ledger = ledger if ledger is not None else RoundLedger("ampc_mm_vertex")
    n, m = g.n, g.m
    rng = np.random.default_rng(seed)
    erank = rng.permutation(m).astype(np.float32)
    u, v = _edge_ends(g, device)
    jrank = _to(erank, device)
    budget = max(4, int(np.ceil(n ** epsilon)))
    estatus = torch.zeros(m, dtype=torch.int32, device=device)
    launches = 0
    total_q = torch.zeros((), dtype=torch.int64, device=device)
    while host_read((estatus == UNKNOWN).any()) and launches < 64:
        with ledger.shuffle(f"vertex_process_{launches}", m):
            estatus, q = _vertex_launch(estatus, u, v, jrank, n, budget)
            total_q += q
        launches += 1
    st, total_q = ledger.harvest((estatus, total_q))
    total_q = int(total_q)
    ledger.record_queries(total_q, total_q * 12, waves=launches)
    return st == IN, {"launches": launches, "budget": budget,
                      "queries": total_q, "erank": erank}


def mm_mpc_rootset(g: UGraph, seed: int = 0,
                   ledger: Optional[RoundLedger] = None,
                   max_phases: int = 500,
                   device="cuda") -> Tuple[np.ndarray, dict]:
    """MPC rootset baseline: one matching wave a phase, two shuffles a
    phase.  Returns (in_mm bool(m,), stats)."""
    ledger = ledger if ledger is not None else RoundLedger("mpc_mm")
    n, m = g.n, g.m
    rng = np.random.default_rng(seed)
    erank = rng.permutation(m).astype(np.float32)
    u, v = _edge_ends(g, device)
    jrank = _to(erank, device)
    estatus = torch.zeros(m, dtype=torch.int32, device=device)
    phases, remaining = 0, m
    nb = nbytes_of(g.edges)
    while remaining > 0 and phases < max_phases:
        with ledger.shuffle(f"rootset_mark_{phases}", nb):
            estatus, _ = matching._mm_wave(estatus, u, v, jrank, n)
        with ledger.shuffle(f"rootset_remove_{phases}", nb):
            remaining = host_read((estatus == UNKNOWN).sum())
        phases += 1
    st = ledger.harvest(estatus)
    return st == IN, {"phases": phases, "erank": erank}


# ==========================================================================
# Corollary 4.1 applications of the MM black box
# ==========================================================================
def mwm_greedy_ampc(g: UGraph, seed: int = 0,
                    ledger: Optional[RoundLedger] = None,
                    dht=None, snapshot=None,
                    device="cuda") -> Tuple[np.ndarray, dict]:
    """1/2-approx maximum weight matching: greedy by decreasing weight
    (ties broken by a random permutation), via the AMPC MM fixpoint with
    weight-derived ranks injected through ``mm_ampc(erank=...)``.
    Returns (in_matching bool(m,), stats)."""
    if g.weights is None:
        raise ValueError("weighted matching needs a weighted graph")
    rng = np.random.default_rng(seed)
    tie = rng.permutation(g.m).astype(np.float64) / max(g.m, 1)
    # rank: ascending = processed first => sort by decreasing weight
    order = np.argsort(np.lexsort((tie, -g.weights.astype(np.float64))))
    erank = order.astype(np.float32)
    ledger = ledger if ledger is not None else RoundLedger("ampc_mwm")
    in_mm, st = mm_ampc(g, seed=seed, ledger=ledger, erank=erank, dht=dht,
                        snapshot=snapshot, device=device)
    w = float(g.weights[in_mm].sum())
    return in_mm, {"weight": w, **st}


def vertex_cover_2approx(g: UGraph, seed: int = 0,
                         ledger: Optional[RoundLedger] = None,
                         dht=None, snapshot=None,
                         device="cuda") -> Tuple[np.ndarray, dict]:
    """2-approx minimum vertex cover = endpoints of a maximal matching."""
    in_mm, stats = mm_ampc(g, seed=seed, ledger=ledger, dht=dht,
                           snapshot=snapshot, device=device)
    cover = np.zeros(g.n, bool)
    cover[g.edges[in_mm, 0]] = True
    cover[g.edges[in_mm, 1]] = True
    return cover, {"cover_size": int(cover.sum()), **stats}


# ==========================================================================
# MSF (paper Section 3, Algorithm 2)
# ==========================================================================
def _hook_parent(hooks):
    """The hook forest's parent array: a vertex without a hook is its own
    root."""
    ids = torch.arange(hooks.shape[0], dtype=torch.int32,
                       device=hooks.device)
    return torch.where(hooks >= 0, hooks, ids)


def _msf_assemble(orig_eid, m, dmask, eids_h, q_h, jump_h, live_h, phases_h,
                  cases_h, budget, nt):
    """Sparse-path output assembly shared by the 5-shuffle, the fused
    session and the batched paths: union the Prim-discovered edges (tern
    eids mapped back through ``orig_eid``) into the dense-phase mask, and
    build the stats."""
    total_q = int(q_h)
    prim_eids = np.asarray(eids_h).ravel()
    prim_eids = prim_eids[prim_eids >= 0]
    orig = orig_eid[prim_eids]
    orig = orig[orig >= 0]
    mask = dmask.copy()
    if m:
        mask[orig] = True
    live_v = int(live_h)
    stats = {
        "path": "sparse",
        "budget": budget,
        "n_tern": nt,
        "queries": total_q,
        "avg_queries_per_vertex": total_q / max(nt, 1),
        "pointer_jump_iters": int(jump_h),
        "contracted_vertices": live_v,
        "shrink_factor": nt / max(live_v, 1),
        "dense_phases": int(phases_h),
        "stop_cases": {int(k): int(c) for k, c in zip(
            *np.unique(np.asarray(cases_h), return_counts=True))},
    }
    return mask, stats


def msf_ampc(g: UGraph, epsilon: float = 0.5, seed: int = 0,
             ledger: Optional[RoundLedger] = None,
             skip_ternarize_if_dense: bool = True,
             dht=None, snapshot=None,
             device="cuda") -> Tuple[np.ndarray, dict]:
    """Compute the MSF mask over g.edges.  Returns (mask, stats).

    ``snapshot`` switches to the fused session path: the ternarized
    adjacency (or the dense edge image) comes from the session's cached KV
    view — cold it is built under one ``WriteTernKV`` / ``WriteGraphKV``
    shuffle, warm it is free — and the whole solve then runs in a single
    ``MSF`` round (2 shuffles cold, 1 warm, vs the cold path's 5).  The
    rank permutation is still the *first* per-solve draw from ``seed``, so
    outputs equal the snapshot-free path's.
    """
    ledger = ledger if ledger is not None else RoundLedger("ampc_msf")
    if g.weights is None:
        raise ValueError("msf needs a weighted graph")
    n, m = g.n, g.m
    rng = np.random.default_rng(seed)

    dense = skip_ternarize_if_dense and m >= n ** (1.0 + epsilon / 2.0)
    if dense:
        # Proposition 3.1 path: run the dense routine directly.
        if snapshot is not None:
            entries, snap_hit = snapshot.materialize_dense(ledger)
            u, v, w = entries["edge_u"], entries["edge_v"], entries["edge_w"]
            shuffle_nbytes = 0  # the write was accounted at view build
        else:
            u, v = _to(g.edges[:, 0], device), _to(g.edges[:, 1], device)
            w = _to(g.weights, device)
            shuffle_nbytes = nbytes_of(g.edges, g.weights)
        eid = torch.arange(m, dtype=torch.int32, device=device)
        valid = torch.ones(m, dtype=torch.bool, device=device)
        with ledger.shuffle("DenseMSF", shuffle_nbytes):
            mask_dev, _, phases = boruvka_inround(u, v, w, eid, valid, n, m)
            col_dev = _collect_dev(dht, ledger, mask_dev.to(torch.int32))
            mask = ledger.harvest(col_dev).astype(bool)
        stats = {"phases": phases, "path": "dense"}
        if snapshot is not None:
            stats["snapshot"] = snapshot.stat(snap_hit)
        return mask, stats

    if snapshot is not None:
        # fused session path: read the ternarized view from the snapshot
        # cache, then run Prim -> jump -> contract -> Borůvka in ONE round
        entries, snap_hit = snapshot.materialize_tern(ledger)
        tg = entries["tg"]
        nt = tg.g.n
        rank = rng.permutation(nt).astype(np.float32)
        budget = max(2, int(np.ceil(nt ** (epsilon / 2.0))))
        with ledger.shuffle("MSF", 0):
            out_eids, hooks, cases, queries = truncated_prim(
                entries["nbr"], entries["nbw"], entries["nbe"],
                _to(rank, device), budget)
            q_sum = queries.sum()
            ledger.record_queries_deferred(q_sum, q_sum * 36, waves=1)
            roots, jump_iters = pointer_jump(_hook_parent(hooks))
            ledger.record_queries_deferred(jump_iters * nt,
                                           jump_iters * nt * 4, waves=1)
            cu, cv, cw, ceid, cvalid, live = contract_edges(
                entries["tu"], entries["tv"], entries["tw"],
                entries["teid"],
                torch.ones(tg.g.m, dtype=torch.bool, device=device), roots)
            dmask_dev, _, phases = boruvka_inround(cu, cv, cw, ceid, cvalid,
                                                   nt, max(m, 1))
            col_dev = _collect_dev(dht, ledger, dmask_dev.to(torch.int32))
            dmask, eids_h, q_h, live_h, cases_h = ledger.harvest(
                (col_dev, out_eids, q_sum, live, cases))
            dmask = dmask.astype(bool)
        mask, stats = _msf_assemble(tg.orig_eid, m, dmask, eids_h, q_h,
                                    jump_iters, live_h, phases, cases_h,
                                    budget, nt)
        stats["snapshot"] = snapshot.stat(snap_hit)
        return mask, stats

    # --- shuffle 1: SortGraph (ternarize + build sorted adjacency, write DHT)
    with ledger.shuffle("SortGraph", nbytes_of(g.edges, g.weights)):
        tg = ternarize(g)
        nbr, nbw, nbe = tg.g.padded_adj(3)
        nt = tg.g.n
        rank = rng.permutation(nt).astype(np.float32)
        budget = max(2, int(np.ceil(nt ** (epsilon / 2.0))))
    ledger.record_queries(0, 0, waves=0)

    # --- shuffle 2: PrimSearch (adaptive queries against the DHT snapshot)
    t_nbr, t_nbw, t_nbe = (_to(a, device) for a in (nbr, nbw, nbe))
    t_rank = _to(rank, device)
    with ledger.shuffle("PrimSearch", 0):
        out_eids, hooks, cases, queries = truncated_prim(
            t_nbr, t_nbw, t_nbe, t_rank, budget)
        q_sum = queries.sum()
    row_bytes = 3 * (4 + 4 + 4)
    ledger.record_queries_deferred(q_sum, q_sum * row_bytes, waves=1)

    # --- shuffle 3: PointerJump (contract the hook forest, Prop 3.2)
    with ledger.shuffle("PointerJump", nbytes_of(hooks)):
        roots, jump_iters = pointer_jump(_hook_parent(hooks))
    ledger.record_queries_deferred(jump_iters * nt, jump_iters * nt * 4,
                                   waves=1)

    # --- shuffle 4: Contract (relabel + dedup on the ternarized edge list)
    tu, tv = _to(tg.g.edges[:, 0], device), _to(tg.g.edges[:, 1], device)
    tw, teid = _to(tg.g.weights, device), _to(tg.orig_eid, device)
    with ledger.shuffle("Contract", nbytes_of(tg.g.edges, tg.g.weights)):
        cu, cv, cw, ceid, cvalid, live = contract_edges(
            tu, tv, tw, teid,
            torch.ones(tg.g.m, dtype=torch.bool, device=device), roots)

    # --- shuffle 5: DenseMSF on the contracted graph, then the solve's
    # single harvest: every output tensor and deferred counter, one transfer
    with ledger.shuffle("DenseMSF", 0):
        dmask_dev, _, phases = boruvka_inround(cu, cv, cw, ceid, cvalid,
                                               nt, max(m, 1))
        col_dev = _collect_dev(dht, ledger, dmask_dev.to(torch.int32))
        dmask, eids_h, q_h, live_h, cases_h = ledger.harvest(
            (col_dev, out_eids, q_sum, live, cases))
        dmask = dmask.astype(bool)
    return _msf_assemble(tg.orig_eid, m, dmask, eids_h, q_h, jump_iters,
                         live_h, phases, cases_h, budget, nt)


def msf_mpc_boruvka(g: UGraph, seed: int = 0,
                    ledger: Optional[RoundLedger] = None,
                    max_phases: int = 200,
                    device="cuda") -> Tuple[np.ndarray, dict]:
    """MPC red/blue Borůvka baseline (paper Section 5.5), 3 shuffles a
    phase; one colour vector ``rng.random(n) < 0.5`` drawn a phase.
    Returns (mask over g.edges, stats)."""
    ledger = ledger if ledger is not None else RoundLedger("mpc_msf")
    n, m = g.n, g.m
    rng = np.random.default_rng(seed)
    u, v = _to(g.edges[:, 0], device), _to(g.edges[:, 1], device)
    w = _to(g.weights, device)
    eid = torch.arange(m, dtype=torch.int32, device=device)
    valid = torch.ones(m, dtype=torch.bool, device=device)
    labels = torch.arange(n, dtype=torch.int32, device=device)
    mask = torch.zeros(m, dtype=torch.bool, device=device)
    phase_bytes = nbytes_of(g.edges, g.weights)
    phases = 0
    remaining = m
    while remaining > 0 and phases < max_phases:
        color = _to(rng.random(n) < 0.5, device)
        # the paper's MPC algorithm performs 3 shuffles per contraction
        # phase
        with ledger.shuffle(f"boruvka_minedge_{phases}", phase_bytes):
            pass
        with ledger.shuffle(f"boruvka_hook_{phases}", n * 4):
            labels, selected, valid, rem = _mpc_boruvka_phase(
                u, v, w, eid, valid, labels, color, m)
        with ledger.shuffle(f"boruvka_relabel_{phases}", phase_bytes):
            mask |= selected
            remaining = host_read(rem)
        phases += 1
    return ledger.harvest(mask), {"phases": phases}


# ==========================================================================
# Connectivity (paper Theorem 1)
# ==========================================================================
def _compose_labels(dht, ledger, dlabels, roots, first_slot):
    """Compose the contractions: each original vertex's label, read as
    dense label of its first tern slot's root — two genuine DHT reads of
    the label maps (``dht_gather`` on the card) when ``dht`` is given."""
    if dht is None:
        return dlabels[roots.long()][first_slot.long()]
    final_tern = dht.lookup(dlabels, roots, ledger=ledger)
    return dht.lookup(final_tern, first_slot, ledger=ledger)


def cc_ampc(g: UGraph, epsilon: float = 0.5, seed: int = 0,
            ledger: Optional[RoundLedger] = None,
            dht=None, snapshot=None,
            device="cuda") -> Tuple[np.ndarray, dict]:
    """Connected components; returns (labels(n,) canonical, stats).

    ``snapshot`` switches to the fused session path (see :func:`msf_ampc`):
    the unit-weight ternarization + first-slot map come from the session's
    ``tern_cc`` KV view (one ``WriteTernKV`` shuffle, cold only) and the
    solve runs in a single ``Connectivity`` round — 2 shuffles cold, 1
    warm, equal labels.
    """
    ledger = ledger if ledger is not None else RoundLedger("ampc_cc")
    n, m = g.n, g.m
    if m == 0:
        stats = {"queries": 0}
        if snapshot is not None:
            # nothing to materialize; the trivial answer never hits the KV
            stats["snapshot"] = snapshot.stat(False)
        return np.arange(n, dtype=np.int64), stats
    rng = np.random.default_rng(seed)

    if snapshot is not None:
        entries, snap_hit = snapshot.materialize_tern(ledger, unit=True)
        tg = entries["tg"]
        nt = tg.g.n
        rank = rng.permutation(nt).astype(np.float32)
        budget = max(2, int(np.ceil(nt ** (epsilon / 2.0))))
        with ledger.shuffle("Connectivity", 0):
            out_eids, hooks, cases, queries = truncated_prim(
                entries["nbr"], entries["nbw"], entries["nbe"],
                _to(rank, device), budget)
            q_sum = queries.sum()
            ledger.record_queries_deferred(q_sum, q_sum * 36, waves=1)
            roots, jump_iters = pointer_jump(_hook_parent(hooks))
            cu, cv, cw, ceid, cvalid, live = contract_edges(
                entries["tu"], entries["tv"], entries["tw"],
                entries["teid"],
                torch.ones(tg.g.m, dtype=torch.bool, device=device), roots)
            _, dlabels, phases = boruvka_inround(cu, cv, cw, ceid, cvalid,
                                                 nt, max(m, 1))
            orig_dev = _compose_labels(dht, ledger, dlabels, roots,
                                       entries["first_slot"])
            orig_labels, q_h = ledger.harvest((orig_dev, q_sum))
            orig_labels = orig_labels.astype(np.int64)
        labels = _canonicalize(orig_labels)
        return labels, {
            "queries": int(q_h),
            "pointer_jump_iters": jump_iters,
            "dense_phases": phases,
            "num_components": int(len(np.unique(labels))),
            "snapshot": snapshot.stat(snap_hit),
        }

    # unit-ish weights, distinct so ties never arise
    gw = UGraph(n, g.edges, np.arange(m, dtype=np.float32))
    with ledger.shuffle("SortGraph", nbytes_of(gw.edges)):
        tg = ternarize(gw)
        nbr, nbw, nbe = tg.g.padded_adj(3)
        nt = tg.g.n
        rank = rng.permutation(nt).astype(np.float32)
        budget = max(2, int(np.ceil(nt ** (epsilon / 2.0))))
        # first tern slot of each original vertex (node_of is sorted)
        first_slot = np.searchsorted(tg.node_of, np.arange(n))

    with ledger.shuffle("PrimSearch", 0):
        out_eids, hooks, cases, queries = truncated_prim(
            *(_to(a, device) for a in (nbr, nbw, nbe, rank)), budget)
        q_sum = queries.sum()
    ledger.record_queries_deferred(q_sum, q_sum * 36, waves=1)

    with ledger.shuffle("PointerJump", nbytes_of(hooks)):
        roots, jump_iters = pointer_jump(_hook_parent(hooks))

    tu, tv = _to(tg.g.edges[:, 0], device), _to(tg.g.edges[:, 1], device)
    tw, teid = _to(tg.g.weights, device), _to(tg.orig_eid, device)
    with ledger.shuffle("Contract", nbytes_of(tg.g.edges)):
        cu, cv, cw, ceid, cvalid, live = contract_edges(
            tu, tv, tw, teid,
            torch.ones(tg.g.m, dtype=torch.bool, device=device), roots)

    with ledger.shuffle("ForestConnectivity", 0):
        _, dlabels, phases = boruvka_inround(cu, cv, cw, ceid, cvalid, nt,
                                             max(m, 1))
        orig_dev = _compose_labels(dht, ledger, dlabels, roots,
                                   _to(first_slot.astype(np.int32), device))
        orig_labels, q_h = ledger.harvest((orig_dev, q_sum))
        orig_labels = orig_labels.astype(np.int64)

    labels = _canonicalize(orig_labels)
    stats = {
        "queries": int(q_h),
        "pointer_jump_iters": jump_iters,
        "dense_phases": phases,
        "num_components": int(len(np.unique(labels))),
    }
    return labels, stats


def cc_mpc_hash_to_min(g: UGraph, ledger: Optional[RoundLedger] = None,
                       max_phases: int = 200,
                       device="cuda") -> Tuple[np.ndarray, dict]:
    """MPC baseline: hash-to-min label propagation, one launch and two
    shuffles a phase.  Returns (labels(n,) canonical, stats)."""
    ledger = ledger if ledger is not None else RoundLedger("mpc_cc")
    n = g.n
    u, v = _edge_ends(g, device)
    labels = torch.arange(n, dtype=torch.int32, device=device)
    phases = 0
    nb = nbytes_of(g.edges)
    while phases < max_phases:
        with ledger.shuffle(f"h2m_join_{phases}", nb):
            labels, changed = _h2m_phase(u, v, labels)
        with ledger.shuffle(f"h2m_update_{phases}", n * 4):
            ch = host_read(changed)
        phases += 1
        if not ch:
            break
    labels = _canonicalize(ledger.harvest(labels).astype(np.int64))
    return labels, {"phases": phases,
                    "num_components": int(len(np.unique(labels)))}


# ==========================================================================
# 1-vs-2-Cycle (paper Section 5.6)
# ==========================================================================
def _cycle_samples(rng, n: int, p: float) -> np.ndarray:
    """The walk's sample set: each vertex with probability ``p``, and at
    least one (paper: w.h.p. argument)."""
    sampled = rng.random(n) < p
    if not sampled.any():
        sampled[rng.integers(n)] = True
    return sampled


def one_vs_two_ampc(g: UGraph, p: float = 1.0 / 64, seed: int = 0,
                    ledger: Optional[RoundLedger] = None,
                    max_steps: Optional[int] = None, snapshot=None,
                    device="cuda") -> Tuple[int, dict]:
    """Returns (num_cycles, stats): vertices sampled with probability
    ``p`` walk to the next sample inside one round.

    ``snapshot`` reads the cycle adjacency from the session's ``cycle_adj``
    KV view instead of rebuilding it under the ``WriteKV`` shuffle; the
    sample set is still drawn per solve (same rng order), so the answer is
    the same — 2 shuffles cold, 1 warm.
    """
    ledger = ledger if ledger is not None else RoundLedger("ampc_1v2c")
    n = g.n
    rng = np.random.default_rng(seed)
    snap_stat = None
    if snapshot is not None:
        entries, snap_hit = snapshot.materialize_cycle(ledger)
        nbr = entries["cycle_nbr"]
        sampled_np = _cycle_samples(rng, n, p)
        sampled = _to(sampled_np, device)
        snap_stat = snapshot.stat(snap_hit)
    else:
        with ledger.shuffle("WriteKV", nbytes_of(g.edges)):
            nbr = _to(cycle_adjacency(g), device)
            sampled_np = _cycle_samples(rng, n, p)
            sampled = _to(sampled_np, device)
    ms = max_steps or int(min(n + 1, np.ceil(8 * np.log(max(n, 2)) / p)))
    with ledger.shuffle("SampleWalk", int(sampled_np.sum()) * 4):
        ncomp, steps, ok = ledger.harvest(_walk_and_count(nbr, sampled, ms))
        ncomp, total_steps, ok = int(ncomp), int(steps), bool(ok)
    ledger.record_queries(total_steps, total_steps * 12, waves=1)
    if not ok:
        raise RuntimeError("walk budget exceeded; increase p or max_steps")
    stats = {"samples": int(sampled_np.sum()),
             "walk_steps": total_steps, "max_steps": ms}
    if snap_stat is not None:
        stats["snapshot"] = snap_stat
    return ncomp, stats


def one_vs_two_mpc(g: UGraph, seed: int = 0,
                   ledger: Optional[RoundLedger] = None,
                   device="cuda") -> Tuple[int, dict]:
    """CC-LocalContraction MPC baseline (Section 5.6): each phase removes
    the rank-local-minima of every cycle and reconnects; 3 shuffles per
    phase, O(log n) phases (at most 200); the residual graph is finished
    in memory."""
    ledger = ledger if ledger is not None else RoundLedger("mpc_1v2c")
    n = g.n
    rng = np.random.default_rng(seed)
    nbr = cycle_adjacency(g)
    a, b = _to(nbr[:, 0], device), _to(nbr[:, 1], device)
    rank = _to(rng.permutation(n).astype(np.float32), device)
    ids = torch.arange(n, dtype=torch.int32, device=device)
    parent = ids
    alive = torch.ones(n, dtype=torch.bool, device=device)
    phases, remaining = 0, n
    nb = nbytes_of(g.edges)
    shrink = []
    while remaining > 0 and phases < 200:
        prev = remaining
        with ledger.shuffle(f"lc_minima_{phases}", nb):
            a, b, parent, alive, rem = _local_contraction_phase(
                a, b, parent, alive, rank)
        with ledger.shuffle(f"lc_reconnect_{phases}", nb):
            remaining = host_read(rem)
        with ledger.shuffle(f"lc_relabel_{phases}", n * 4):
            shrink.append(prev / max(remaining, 1))
        phases += 1
    # in-memory finish: pointer-jump parents to roots; the distinct roots
    # are the roots' own fixed points
    roots, _ = pointer_jump(parent)
    ncomp = int(ledger.harvest((roots == ids).sum()))
    return ncomp, {"phases": phases, "shrink_per_phase": shrink}


# ==========================================================================
# Registry entries — the engine's dispatch table
# ==========================================================================
@problem("mis", model="ampc", output="vertex_mask", aliases=("ampc-mis",),
         table3_shuffles=2,
         summary="LFMIS by in-round dependency fixpoint (Fig 1)")
def _p_mis(ctx, g, **opts):
    return mis_ampc(g, seed=ctx.seed, ledger=ctx.ledger, dht=ctx.dht,
                    device=ctx.device, **opts)


@problem("mis-mpc", model="mpc", output="vertex_mask", baseline_of="mis",
         summary="MPC rootset baseline, 2 shuffles/phase (Fig 2)")
def _p_mis_mpc(ctx, g, **opts):
    return mis_mpc_rootset(g, seed=ctx.seed, ledger=ctx.ledger,
                           device=ctx.device, **opts)


@problem("matching", model="ampc", output="edge_mask",
         aliases=("mm", "maximal-matching"), table3_shuffles=2,
         summary="LFMM by in-round edge fixpoint (Section 5.4)")
def _p_mm(ctx, g, **opts):
    return mm_ampc(g, seed=ctx.seed, ledger=ctx.ledger, dht=ctx.dht,
                   device=ctx.device, **opts)


@problem("matching-levels", model="ampc", output="edge_mask",
         summary="Algorithm 4: O(log log Δ) geometric sampling levels")
def _p_mm_levels(ctx, g, **opts):
    return mm_ampc_levels(g, seed=ctx.seed, ledger=ctx.ledger,
                          device=ctx.device, **opts)


@problem("matching-vertex-process", model="ampc", output="edge_mask",
         summary="Theorem 2.2: n^ε-budget truncated vertex query process")
def _p_mm_vertex(ctx, g, **opts):
    return mm_ampc_vertex_process(g, epsilon=ctx.epsilon, seed=ctx.seed,
                                  ledger=ctx.ledger, device=ctx.device,
                                  **opts)


@problem("matching-mpc", model="mpc", output="edge_mask",
         baseline_of="matching",
         summary="MPC rootset baseline, 2 shuffles/phase")
def _p_mm_mpc(ctx, g, **opts):
    return mm_mpc_rootset(g, seed=ctx.seed, ledger=ctx.ledger,
                          device=ctx.device, **opts)


@problem("weighted-matching", model="ampc", output="edge_mask",
         aliases=("mwm",), needs_weights=True, table3_shuffles=2,
         summary="Corollary 4.1: greedy 1/2-approx MWM via erank injection")
def _p_mwm(ctx, g, **opts):
    return mwm_greedy_ampc(g, seed=ctx.seed, ledger=ctx.ledger, dht=ctx.dht,
                           device=ctx.device, **opts)


@problem("vertex-cover", model="ampc", output="vertex_mask",
         summary="Corollary 4.1: 2-approx vertex cover = V(maximal matching)")
def _p_vc(ctx, g, **opts):
    return vertex_cover_2approx(g, seed=ctx.seed, ledger=ctx.ledger,
                                dht=ctx.dht, device=ctx.device, **opts)


@problem("msf", model="ampc", output="edge_mask", needs_weights=True,
         table3_shuffles=5,
         summary="Algorithm 2: 5-shuffle truncated-Prim MSF")
def _p_msf(ctx, g, **opts):
    return msf_ampc(g, epsilon=ctx.epsilon, seed=ctx.seed, ledger=ctx.ledger,
                    dht=ctx.dht, device=ctx.device, **opts)


@problem("msf-kkt", model="ampc", output="edge_mask", needs_weights=True,
         summary="Algorithm 3: KKT sample + F-light filter + MSF")
def _p_msf_kkt(ctx, g, **opts):
    from ..core.kkt_filter import msf_kkt
    return msf_kkt(g, epsilon=ctx.epsilon, seed=ctx.seed, ledger=ctx.ledger,
                   device=ctx.device, **opts)


@problem("msf-mpc", model="mpc", output="edge_mask", needs_weights=True,
         baseline_of="msf",
         summary="MPC red/blue Borůvka baseline, 3 shuffles/phase")
def _p_msf_mpc(ctx, g, **opts):
    return msf_mpc_boruvka(g, seed=ctx.seed, ledger=ctx.ledger,
                           device=ctx.device, **opts)


@problem("connectivity", model="ampc", output="labels", aliases=("cc",),
         table3_shuffles=5,
         summary="Theorem 1: MSF on unit weights + forest connectivity")
def _p_cc(ctx, g, **opts):
    return cc_ampc(g, epsilon=ctx.epsilon, seed=ctx.seed, ledger=ctx.ledger,
                   dht=ctx.dht, device=ctx.device, **opts)


@problem("connectivity-mpc", model="mpc", output="labels",
         baseline_of="connectivity",
         summary="MPC hash-to-min label propagation baseline")
def _p_cc_mpc(ctx, g, **opts):
    return cc_mpc_hash_to_min(g, ledger=ctx.ledger, device=ctx.device,
                              **opts)


@problem("one-vs-two", model="ampc", output="count", aliases=("1v2c",),
         needs_cycles=True, table3_shuffles=2,
         summary="Section 5.6: adaptive cycle walk, the AMPC/MPC separation")
def _p_1v2(ctx, g, **opts):
    return one_vs_two_ampc(g, seed=ctx.seed, ledger=ctx.ledger,
                           device=ctx.device, **opts)


@problem("one-vs-two-mpc", model="mpc", output="count",
         baseline_of="one-vs-two", needs_cycles=True,
         summary="CC-LocalContraction MPC baseline, 3 shuffles/phase")
def _p_1v2_mpc(ctx, g, **opts):
    return one_vs_two_mpc(g, seed=ctx.seed, ledger=ctx.ledger,
                          device=ctx.device, **opts)


# ==========================================================================
# Batched adapters — AmpcEngine.solve_many, one launch per bucket
# ==========================================================================
# Each adapter takes (bctx: engine.BatchSolveContext, batch: GraphBatch) and
# returns one (output, stats) per graph, in batch order.  Invariants:
#
#   * outputs equal sequential ``solve`` on the same engine seed: each lane
#     pads with inert edges/vertices and uses the graph's *own* (unpadded)
#     rank permutation, so the fixpoint trajectory over the real
#     vertices/edges is exactly the sequential one;
#   * a bucket runs as ONE eager loop over its offset-flattened lanes (lane
#     b owns the b-th range of vertex and edge ids); per-lane counters are
#     reduced by lane, so each graph's stats are its sequential ones, and
#     one host read a wave serves the whole bucket;
#   * the bucket's solver (a closure over its shape and static budget) is
#     memoized per (problem, backend, bucket) through ``bctx.cache``; all
#     graphs after the first occupant of a bucket ride the same solver
#     (stats["solver_cache"]);
#   * per-graph ledgers mirror the reference's batched shuffle structure,
#     with this graph's own bytes and its mask's share of the batched DHT
#     traffic; the bucket makes one ``harvest_many`` transfer.


def _cache_stat(key, hit: bool, slot: int) -> dict:
    # slot 0 of a cold bucket pays the build; every later occupant is a hit
    return {"key": key, "hit": bool(hit or slot > 0)}


def _per_graph_ranks(batch, seed: int):
    """Per-graph vertex rank permutations, padded to n_bucket.

    Each graph draws from ``default_rng(seed)`` exactly like the sequential
    solver; padding vertices get ranks above every real rank (they are
    isolated, so the value never matters)."""
    B, nb = len(batch), batch.n_bucket
    ranks = np.zeros((B, nb), np.float32)
    for b, g in enumerate(batch.graphs):
        rng = np.random.default_rng(seed)
        ranks[b, :g.n] = rng.permutation(g.n).astype(np.float32)
        ranks[b, g.n:] = np.arange(g.n, nb, dtype=np.float32)
    return ranks


def _flat_ids(ids, n: int):
    """(B, ...) lane-local ids to one flat id space: lane b's id k becomes
    ``b * n + k``; negative ids (padding) stay -1."""
    B = ids.shape[0]
    off = (torch.arange(B, dtype=ids.dtype, device=ids.device) * n).view(
        (B,) + (1,) * (ids.dim() - 1))
    return torch.where(ids >= 0, ids + off, -1).reshape(-1)


def _lane_keys(B: int, K: int, device):
    """(B, K) int32 keys 0..K-1 in every row: CollectOutputs reads each
    graph's whole output snapshot."""
    return torch.arange(K, dtype=torch.int32, device=device).expand(B, K)


def _build_mis_solver(n: int):
    def solve(senders, receivers, rank, edge_ok):
        B = rank.shape[0]
        status, _, iters, q0, q1 = _mis_fixpoint_lanes(
            _flat_ids(senders, n), _flat_ids(receivers, n),
            rank.reshape(-1), n, B, edge_ok.reshape(-1))
        return status.view(B, n), iters, q0, q1
    return solve


@batched_impl("mis")
def mis_ampc_batched(bctx, batch, caching: bool = True):
    """Batched MIS: one masked-fixpoint loop over the whole bucket."""
    B, nb = len(batch), batch.n_bucket
    dev = bctx.device
    senders, receivers, edge_ok = batch.padded_symmetric()
    ranks = _per_graph_ranks(batch, bctx.seed)
    for b, g in enumerate(batch.graphs):
        bctx.ledgers[b].record_shuffle("DirectEdges+WriteKV",
                                       nbytes_of(g.edges) * 2)
    key = bctx.solver_key(batch)
    solver, hit = bctx.cache.get_or_build(
        key, lambda: _build_mis_solver(nb), occupants=B)
    t0 = time.perf_counter()
    status_b, iters_b, q0_b, q1_b = solver(
        _to(senders, dev), _to(receivers, dev), _to(ranks, dev),
        _to(edge_ok, dev))
    # CollectOutputs: one batched DHT read, per-graph queries split by mask
    out_b = bctx.dht.lookup_many(status_b, _lane_keys(B, nb, dev),
                                 ledgers=bctx.ledgers,
                                 key_mask=batch.node_mask)
    # the bucket's one transfer: outputs + every ledger's deferred counters
    status_h, iters, q0, q1 = harvest_many(
        bctx.ledgers, (out_b, iters_b, q0_b, q1_b))
    dt = time.perf_counter() - t0
    outs = []
    for b, g in enumerate(batch.graphs):
        led = bctx.ledgers[b]
        led.record_shuffle("IsInMIS", g.n * 4, seconds=dt / B)
        qn, qd, it = int(q0[b]), int(q1[b]), int(iters[b])
        queries = qd if caching else qn
        led.record_queries(queries, queries * 8, waves=it,
                           deduped_away=(qn - qd) if caching else 0)
        status = status_h[b, :g.n]
        if (status == UNKNOWN).any():
            raise RuntimeError("MIS fixpoint left undecided vertices")
        outs.append((status == IN,
                     {"fixpoint_iters": it, "queries_nodedup": qn,
                      "queries_dedup": qd,
                      "cache_savings_factor": qn / max(qd, 1),
                      "solver_cache": _cache_stat(key, hit, b)}))
    return outs


def _build_mm_solver(n: int):
    def solve(u, v, rank, st0):
        B = rank.shape[0]
        estatus, _, iters, q0, q1 = matching._mm_fixpoint_lanes(
            _flat_ids(u, n), _flat_ids(v, n), rank.reshape(-1), n, B,
            st0.reshape(-1))
        return estatus.view(B, -1), iters, q0, q1
    return solve


def _mm_batched_launch(bctx, batch, eranks, caching: bool = True):
    """Shared batched greedy-MM launch (matching / mwm / vertex-cover).

    ``eranks`` is one unpadded rank array per graph (the Corollary-4.1
    injection point); padding edges start OUT so they never join or block.
    The solver is shared across every problem that rides it — the cache key
    is scoped to ``"matching"``, not the caller's name.
    """
    B, nb, mb = len(batch), batch.n_bucket, batch.m_bucket
    dev = bctx.device
    ranks = np.full((B, mb), np.inf, np.float32)
    for b, er in enumerate(eranks):
        ranks[b, :er.shape[0]] = er
    estatus0 = np.where(batch.edge_mask, np.int32(UNKNOWN),
                        np.int32(matching.OUT)).astype(np.int32)
    for b, g in enumerate(batch.graphs):
        bctx.ledgers[b].record_shuffle("SortEdges+WriteKV",
                                       nbytes_of(g.edges) * 2)
    key = ("matching", bctx.backend_name, nb, mb)
    solver, hit = bctx.cache.get_or_build(
        key, lambda: _build_mm_solver(nb), occupants=B)
    t0 = time.perf_counter()
    estatus_b, iters_b, q0_b, q1_b = solver(
        _to(batch.edges[:, :, 0], dev), _to(batch.edges[:, :, 1], dev),
        _to(ranks, dev), _to(estatus0, dev))
    out_b = bctx.dht.lookup_many(estatus_b, _lane_keys(B, mb, dev),
                                 ledgers=bctx.ledgers,
                                 key_mask=batch.edge_mask)
    estatus_h, iters, q0, q1 = harvest_many(
        bctx.ledgers, (out_b, iters_b, q0_b, q1_b))
    dt = time.perf_counter() - t0
    outs = []
    for b, g in enumerate(batch.graphs):
        led = bctx.ledgers[b]
        led.record_shuffle("IsInMM", g.m, seconds=dt / B)
        qn, qd, it = int(q0[b]), int(q1[b]), int(iters[b])
        queries = qd if caching else qn
        led.record_queries(queries, queries * 12, waves=it,
                           deduped_away=(qn - qd) if caching else 0)
        estatus = estatus_h[b, :g.m]
        outs.append((estatus == IN,
                     {"fixpoint_iters": it, "queries_nodedup": qn,
                      "queries_dedup": qd, "erank": eranks[b],
                      "solver_cache": _cache_stat(key, hit, b)}))
    return outs


@batched_impl("matching")
def mm_ampc_batched(bctx, batch, caching: bool = True):
    """Batched greedy maximal matching over per-graph random edge ranks."""
    eranks = []
    for g in batch.graphs:
        rng = np.random.default_rng(bctx.seed)
        eranks.append(rng.permutation(g.m).astype(np.float32))
    return _mm_batched_launch(bctx, batch, eranks, caching=caching)


@batched_impl("weighted-matching")
def mwm_greedy_ampc_batched(bctx, batch, caching: bool = True):
    """Batched 1/2-approx MWM: decreasing-weight eranks into the MM launch."""
    eranks = []
    for g in batch.graphs:
        rng = np.random.default_rng(bctx.seed)
        tie = rng.permutation(g.m).astype(np.float64) / max(g.m, 1)
        order = np.argsort(np.lexsort((tie, -g.weights.astype(np.float64))))
        eranks.append(order.astype(np.float32))
    outs = _mm_batched_launch(bctx, batch, eranks, caching=caching)
    return [(in_mm, {"weight": float(g.weights[in_mm].sum()), **st})
            for g, (in_mm, st) in zip(batch.graphs, outs)]


@batched_impl("vertex-cover")
def vertex_cover_2approx_batched(bctx, batch, caching: bool = True):
    """Batched 2-approx vertex cover: endpoints of the batched MM."""
    outs = mm_ampc_batched(bctx, batch, caching=caching)
    results = []
    for g, (in_mm, st) in zip(batch.graphs, outs):
        cover = np.zeros(g.n, bool)
        cover[g.edges[in_mm, 0]] = True
        cover[g.edges[in_mm, 1]] = True
        results.append((cover, {"cover_size": int(cover.sum()), **st}))
    return results


def _build_msf_sparse_solver(ntb: int, mb: int, capacity: int):
    """Sparse-MSF pipeline for one ternarized bucket shape.

    ``capacity`` is the bucket-max Prim budget: every lane shares the
    buffer size while stopping at its own ``budget`` (outputs equal per
    ``truncated_prim_capped``).  ``mb`` is the bucket's *original* edge
    capacity — the Borůvka mask is over original edge ids (``teid``),
    exactly like the sequential path."""
    def solve(nbr, nbw, nbe, rank, budget, nmask, tu, tv, tw, teid, emask):
        B = rank.shape[0]
        # tern edge ids in nbe are only carried to the output: they stay
        # lane-local
        out_eids, hooks, cases, queries = truncated_prim_capped(
            _flat_ids(nbr, ntb).view(-1, 3), nbw.reshape(-1, 3),
            nbe.reshape(-1, 3), rank.reshape(-1),
            budget.repeat_interleave(ntb), capacity)
        # padded tern vertices exhaust on their first frontier pop; mask
        # their unit query out of the per-graph total
        q_sum = torch.where(nmask.reshape(-1), queries, 0).view(
            B, ntb).sum(1)
        roots, jump_iters = pointer_jump(_hook_parent(hooks), lanes=B)
        cu, cv, cw, ceid, cvalid, live = contract_edges(
            _flat_ids(tu, ntb), _flat_ids(tv, ntb), tw.reshape(-1),
            _flat_ids(teid, mb).to(torch.int32), emask.reshape(-1), roots,
            lanes=B)
        dmask, _, phases = boruvka_core(cu, cv, cw, ceid, cvalid, B * ntb,
                                        B * mb, lanes=B)
        return (dmask.view(B, mb).to(torch.int32),
                out_eids.view(B, ntb, capacity), q_sum, jump_iters, live,
                phases, cases.view(B, ntb))
    return solve


def _build_msf_dense_solver(nb: int, mb: int):
    def solve(u, v, w, emask):
        B = u.shape[0]
        eid = torch.arange(B * mb, dtype=torch.int32, device=u.device)
        dmask, _, phases = boruvka_core(
            _flat_ids(u, nb), _flat_ids(v, nb), w.reshape(-1), eid,
            emask.reshape(-1), B * nb, B * mb, lanes=B)
        return dmask.view(B, mb).to(torch.int32), phases
    return solve


@batched_impl("msf")
def msf_ampc_batched(bctx, batch, skip_ternarize_if_dense: bool = True):
    """Batched MSF: lanes split by the sequential dense/sparse predicate.

    Sparse lanes run one truncated-Prim -> pointer-jump -> contract ->
    Borůvka loop over a shared :func:`ternarize_batch` bucket; dense lanes
    (``m >= n^(1+eps/2)``) run one Borůvka loop, mirroring the sequential
    Proposition-3.1 shortcut.  Each lane pads with isolated tern vertices /
    invalid edges and keeps its own rank permutation and budget, so outputs
    equal sequential ``solve``'s; per-graph ledgers mirror the sequential
    5- (or 1-) shuffle structure, and the whole bucket still materializes
    through exactly one ``harvest_many`` transfer.
    """
    B, mb = len(batch), batch.m_bucket
    dev = bctx.device
    eps = bctx.epsilon
    dense_set = set(
        b for b, g in enumerate(batch.graphs)
        if skip_ternarize_if_dense and g.m >= g.n ** (1.0 + eps / 2.0))
    dense_idx = sorted(dense_set)
    sparse_idx = [b for b in range(B) if b not in dense_set]

    t0 = time.perf_counter()
    sparse_extra = dense_extra = None
    if sparse_idx:
        tb = ternarize_batch([batch.graphs[b] for b in sparse_idx])
        Bs, ntb = len(tb), tb.nt_bucket
        ranks = np.zeros((Bs, ntb), np.float32)
        budgets = np.zeros((Bs,), np.int32)
        for j, t in enumerate(tb.terns):
            nt = t.g.n
            rng = np.random.default_rng(bctx.seed)
            ranks[j, :nt] = rng.permutation(nt).astype(np.float32)
            ranks[j, nt:] = np.arange(nt, ntb, dtype=np.float32)
            budgets[j] = max(2, int(np.ceil(nt ** (eps / 2.0))))
        capacity = int(budgets.max())
        for b in sparse_idx:
            g = batch.graphs[b]
            bctx.ledgers[b].record_shuffle(
                "SortGraph", nbytes_of(g.edges, g.weights))
        skey = bctx.solver_key(batch,
                               ("sparse", ntb, tb.mt_bucket, capacity))
        ssolver, shit = bctx.cache.get_or_build(
            skey, lambda: _build_msf_sparse_solver(ntb, mb, capacity),
            occupants=Bs)
        (dmask_b, eids_b, q_b, jump_b, live_b, phases_b, cases_b) = ssolver(
            *(_to(a, dev) for a in (
                tb.nbr, tb.nbw, tb.nbe, ranks, budgets, tb.node_mask,
                tb.edges[:, :, 0], tb.edges[:, :, 1], tb.weights,
                tb.orig_eid, tb.edge_mask)))
        # per-lane deferred traffic (prim, then pointer-jump) queued on
        # each graph's ledger before the bucket's one harvest
        for j, b in enumerate(sparse_idx):
            nt = tb.terns[j].g.n
            led = bctx.ledgers[b]
            led.record_queries_deferred(q_b[j], q_b[j] * 36, waves=1)
            led.record_queries_deferred(jump_b[j] * nt, jump_b[j] * nt * 4,
                                        waves=1)
        col_b = bctx.dht.lookup_many(
            dmask_b, _lane_keys(Bs, mb, dev),
            ledgers=[bctx.ledgers[b] for b in sparse_idx],
            key_mask=batch.edge_mask[np.asarray(sparse_idx)])
        sparse_extra = (col_b, eids_b, q_b, jump_b, live_b, phases_b,
                        cases_b)
    if dense_idx:
        didx = np.asarray(dense_idx)
        demask = batch.edge_mask[didx]
        dkey = bctx.solver_key(batch, ("dense",))
        dsolver, dhit = bctx.cache.get_or_build(
            dkey, lambda: _build_msf_dense_solver(batch.n_bucket, mb),
            occupants=len(dense_idx))
        dmaskd_b, dphases_b = dsolver(
            *(_to(a, dev) for a in (
                batch.edges[didx, :, 0], batch.edges[didx, :, 1],
                batch.weights[didx], demask)))
        dcol_b = bctx.dht.lookup_many(
            dmaskd_b, _lane_keys(len(dense_idx), mb, dev),
            ledgers=[bctx.ledgers[b] for b in dense_idx], key_mask=demask)
        dense_extra = (dcol_b, dphases_b)

    # the bucket's one transfer: both sub-launches' outputs and every
    # ledger's deferred counters
    sparse_h, dense_h = harvest_many(bctx.ledgers,
                                     (sparse_extra, dense_extra))
    dt = time.perf_counter() - t0

    outs = [None] * B
    if sparse_idx:
        (col_h, eids_h, q_h, jump_h, live_h, phases_h, cases_h) = sparse_h
        for j, b in enumerate(sparse_idx):
            g = batch.graphs[b]
            t = tb.terns[j]
            nt = t.g.n
            led = bctx.ledgers[b]
            led.record_queries(0, 0, waves=0)
            led.record_shuffle("PrimSearch", 0)
            led.record_shuffle("PointerJump", nt * 4)
            led.record_shuffle("Contract", nbytes_of(t.g.edges, t.g.weights))
            led.record_shuffle("DenseMSF", 0, seconds=dt / B)
            mask, stats = _msf_assemble(
                t.orig_eid, g.m, col_h[j, :g.m].astype(bool),
                eids_h[j, :nt], q_h[j], jump_h[j], live_h[j], phases_h[j],
                cases_h[j, :nt], int(budgets[j]), nt)
            stats["solver_cache"] = _cache_stat(skey, shit, j)
            outs[b] = (mask, stats)
    if dense_idx:
        dcol_h, dphases_h = dense_h
        for j, b in enumerate(dense_idx):
            g = batch.graphs[b]
            bctx.ledgers[b].record_shuffle(
                "DenseMSF", nbytes_of(g.edges, g.weights), seconds=dt / B)
            outs[b] = (dcol_h[j, :g.m].astype(bool),
                       {"phases": int(dphases_h[j]), "path": "dense",
                        "solver_cache": _cache_stat(dkey, dhit, j)})
    return outs


def _build_cc_solver(n: int):
    def solve(u, v, ok):
        B = u.shape[0]
        labels, iters, q0, q1 = _cc_fixpoint_masked(
            _flat_ids(u, n), _flat_ids(v, n), ok.reshape(-1), n, B)
        # back to lane-local labels, as each lane's own fixpoint gives them
        off = torch.arange(B, dtype=labels.dtype, device=labels.device) * n
        return labels.view(B, n) - off[:, None], iters, q0, q1
    return solve


@batched_impl("connectivity")
def cc_ampc_batched(bctx, batch):
    """Batched connectivity via in-round min-label doubling (2 shuffles).

    The sequential solver runs the paper's 5-shuffle truncated-Prim
    pipeline; the batched path instead resolves labels by masked
    hash-to-min run to fixpoint against one snapshot, as the reference's
    does.  Outputs are identical after canonicalization (component labels
    are min-vertex-id in both paths); the ledger reflects the 2-shuffle
    batched pipeline.
    """
    B, nb = len(batch), batch.n_bucket
    dev = bctx.device
    for b, g in enumerate(batch.graphs):
        bctx.ledgers[b].record_shuffle("SortGraph+WriteKV",
                                       nbytes_of(g.edges))
    key = bctx.solver_key(batch)
    solver, hit = bctx.cache.get_or_build(
        key, lambda: _build_cc_solver(nb), occupants=B)
    t0 = time.perf_counter()
    labels_b, iters_b, q0_b, q1_b = solver(
        _to(batch.edges[:, :, 0], dev), _to(batch.edges[:, :, 1], dev),
        _to(batch.edge_mask, dev))
    out_b = bctx.dht.lookup_many(labels_b, _lane_keys(B, nb, dev),
                                 ledgers=bctx.ledgers,
                                 key_mask=batch.node_mask)
    labels_h, iters, q0, q1 = harvest_many(
        bctx.ledgers, (out_b, iters_b, q0_b, q1_b))
    dt = time.perf_counter() - t0
    outs = []
    for b, g in enumerate(batch.graphs):
        led = bctx.ledgers[b]
        led.record_shuffle("LabelFixpoint", g.n * 4, seconds=dt / B)
        qn, qd, it = int(q0[b]), int(q1[b]), int(iters[b])
        led.record_queries(qd, qd * 8, waves=it, deduped_away=qn - qd)
        labels = _canonicalize(labels_h[b, :g.n].astype(np.int64))
        outs.append((labels,
                     {"label_prop_iters": it, "queries": qd,
                      "queries_nodedup": qn,
                      "num_components": int(len(np.unique(labels))),
                      "solver_cache": _cache_stat(key, hit, b)}))
    return outs


def _build_1v2_solver(n: int, max_steps: int):
    def solve(nbr, sampled):
        B = nbr.shape[0]
        return _walk_and_count(_flat_ids(nbr, n).view(-1, 2),
                               sampled.reshape(-1), max_steps, lanes=B)
    return solve


@batched_impl("one-vs-two")
def one_vs_two_ampc_batched(bctx, batch, p: float = 1.0 / 64,
                            max_steps: Optional[int] = None):
    """Batched 1-vs-2-cycle: one walk loop per bucket.

    Padding vertices self-loop and are marked sampled, so each contributes
    exactly 2 walk steps and 1 component — both subtracted per graph.  The
    walk budget is the bucket maximum of the per-graph budgets (it only
    bounds the in-round chase; successful walks stop at the next sample
    regardless), and is part of the solver cache key.
    """
    B, nb = len(batch), batch.n_bucket
    dev = bctx.device
    nbrs = np.zeros((B, nb, 2), np.int32)
    sampled = np.zeros((B, nb), bool)
    n_samples = np.zeros(B, np.int64)
    ms = 1
    for b, g in enumerate(batch.graphs):
        nbrs[b, :g.n] = cycle_adjacency(g)
        pads = np.arange(g.n, nb, dtype=np.int32)
        nbrs[b, g.n:, 0] = pads
        nbrs[b, g.n:, 1] = pads
        s = _cycle_samples(np.random.default_rng(bctx.seed), g.n, p)
        sampled[b, :g.n] = s
        sampled[b, g.n:] = True
        n_samples[b] = int(s.sum())
        ms = max(ms, max_steps or
                 int(min(g.n + 1, np.ceil(8 * np.log(max(g.n, 2)) / p))))
        bctx.ledgers[b].record_shuffle("WriteKV", nbytes_of(g.edges))
    key = bctx.solver_key(batch, ("max_steps", ms))
    solver, hit = bctx.cache.get_or_build(
        key, lambda: _build_1v2_solver(nb, ms), occupants=B)
    t0 = time.perf_counter()
    ncomp, steps, ok = harvest_many(
        bctx.ledgers, solver(_to(nbrs, dev), _to(sampled, dev)))
    dt = time.perf_counter() - t0
    outs = []
    for b, g in enumerate(batch.graphs):
        if not bool(ok[b]):
            raise RuntimeError("walk budget exceeded; increase p or "
                               f"max_steps (graph {batch.indices[b]})")
        n_pad = nb - g.n
        real_steps = int(steps[b]) - 2 * n_pad
        led = bctx.ledgers[b]
        led.record_shuffle("SampleWalk", int(n_samples[b]) * 4,
                           seconds=dt / B)
        led.record_queries(real_steps, real_steps * 12, waves=1)
        outs.append((int(ncomp[b]) - n_pad,
                     {"samples": int(n_samples[b]),
                      "walk_steps": real_steps, "max_steps": ms,
                      "solver_cache": _cache_stat(key, hit, b)}))
    return outs
