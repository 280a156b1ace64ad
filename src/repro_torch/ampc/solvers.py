"""AMPC solver drivers — the engine's algorithm layer (torch port).

Ports of the JAX package's ``repro.ampc.solvers`` drivers for ``mis``,
``msf`` and ``connectivity`` on their snapshot-free paths, registered with
:mod:`repro_torch.ampc.registry` so ``AmpcEngine.solve`` reaches them.  The
host-side steps (graph layout, ternarization, the rank permutation drawn
from ``np.random.default_rng(seed)``) are the reference's, so outputs,
stats and ledger counters equal the reference's for the same graph and seed.

The ``dht`` parameter realizes the paper's last step of every AMPC round:
machines read their outputs back from the immutable DHT snapshot
(CollectOutputs).  Every tensor lives on ``device``; each solve ends in one
``RoundLedger.harvest``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.connectivity import _canonicalize
from ..core.mis import IN, UNKNOWN, _mis_fixpoint
from ..core.msf import (boruvka_inround, contract_edges, pointer_jump,
                        truncated_prim)
from ..core.rounds import RoundLedger, nbytes_of
from ..core.ternarize import ternarize
from ..graph.coo import UGraph
from .registry import problem


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
             caching: bool = True, dht=None,
             device="cuda") -> Tuple[np.ndarray, dict]:
    """Returns (in_mis bool(n,), stats)."""
    ledger = ledger if ledger is not None else RoundLedger("ampc_mis")
    n = g.n
    rng = np.random.default_rng(seed)
    rank = rng.permutation(n).astype(np.float32)

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
    return status == IN, stats


# ==========================================================================
# MSF (paper Section 3, Algorithm 2)
# ==========================================================================
def _msf_assemble(orig_eid, m, dmask, eids_h, q_h, jump_h, live_h, phases_h,
                  cases_h, budget, nt):
    """Sparse-path output assembly: union the Prim-discovered edges (tern
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
             dht=None, device="cuda") -> Tuple[np.ndarray, dict]:
    """Compute the MSF mask over g.edges.  Returns (mask, stats)."""
    ledger = ledger if ledger is not None else RoundLedger("ampc_msf")
    if g.weights is None:
        raise ValueError("msf needs a weighted graph")
    n, m = g.n, g.m
    rng = np.random.default_rng(seed)

    dense = skip_ternarize_if_dense and m >= n ** (1.0 + epsilon / 2.0)
    if dense:
        # Proposition 3.1 path: run the dense routine directly.
        u, v = _to(g.edges[:, 0], device), _to(g.edges[:, 1], device)
        w = _to(g.weights, device)
        eid = torch.arange(m, dtype=torch.int32, device=device)
        valid = torch.ones(m, dtype=torch.bool, device=device)
        with ledger.shuffle("DenseMSF", nbytes_of(g.edges, g.weights)):
            mask_dev, _, phases = boruvka_inround(u, v, w, eid, valid, n, m)
            col_dev = _collect_dev(dht, ledger, mask_dev.to(torch.int32))
            mask = ledger.harvest(col_dev).astype(bool)
        return mask, {"phases": phases, "path": "dense"}

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
        parent = torch.where(hooks >= 0, hooks,
                             torch.arange(nt, dtype=torch.int32,
                                          device=device))
        roots, jump_iters = pointer_jump(parent)
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


# ==========================================================================
# Connectivity (paper Theorem 1)
# ==========================================================================
def cc_ampc(g: UGraph, epsilon: float = 0.5, seed: int = 0,
            ledger: Optional[RoundLedger] = None,
            dht=None, device="cuda") -> Tuple[np.ndarray, dict]:
    """Connected components; returns (labels(n,) canonical, stats)."""
    ledger = ledger if ledger is not None else RoundLedger("ampc_cc")
    n, m = g.n, g.m
    if m == 0:
        return np.arange(n, dtype=np.int64), {"queries": 0}
    rng = np.random.default_rng(seed)

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
        parent = torch.where(hooks >= 0, hooks,
                             torch.arange(nt, dtype=torch.int32,
                                          device=device))
        roots, jump_iters = pointer_jump(parent)

    tu, tv = _to(tg.g.edges[:, 0], device), _to(tg.g.edges[:, 1], device)
    tw, teid = _to(tg.g.weights, device), _to(tg.orig_eid, device)
    with ledger.shuffle("Contract", nbytes_of(tg.g.edges)):
        cu, cv, cw, ceid, cvalid, live = contract_edges(
            tu, tv, tw, teid,
            torch.ones(tg.g.m, dtype=torch.bool, device=device), roots)

    with ledger.shuffle("ForestConnectivity", 0):
        _, dlabels, phases = boruvka_inround(cu, cv, cw, ceid, cvalid, nt,
                                             max(m, 1))
        # compose contractions: two genuine DHT reads of the label maps
        keys = _to(first_slot.astype(np.int32), device)
        if dht is not None:
            final_tern = dht.lookup(dlabels, roots, ledger=ledger)
            orig_dev = dht.lookup(final_tern, keys, ledger=ledger)
        else:
            final_tern = dlabels[roots.long()]
            orig_dev = final_tern[keys.long()]
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


# ==========================================================================
# Registry entries — the engine's dispatch table
# ==========================================================================
@problem("mis", model="ampc", output="vertex_mask", aliases=("ampc-mis",),
         table3_shuffles=2,
         summary="LFMIS by in-round dependency fixpoint (Fig 1)")
def _p_mis(ctx, g, **opts):
    return mis_ampc(g, seed=ctx.seed, ledger=ctx.ledger, dht=ctx.dht,
                    device=ctx.device, **opts)


@problem("msf", model="ampc", output="edge_mask", needs_weights=True,
         table3_shuffles=5,
         summary="Algorithm 2: 5-shuffle truncated-Prim MSF")
def _p_msf(ctx, g, **opts):
    return msf_ampc(g, epsilon=ctx.epsilon, seed=ctx.seed, ledger=ctx.ledger,
                    dht=ctx.dht, device=ctx.device, **opts)


@problem("connectivity", model="ampc", output="labels", aliases=("cc",),
         table3_shuffles=5,
         summary="Theorem 1: MSF on unit weights + forest connectivity")
def _p_cc(ctx, g, **opts):
    return cc_ampc(g, epsilon=ctx.epsilon, seed=ctx.seed, ledger=ctx.ledger,
                   dht=ctx.dht, device=ctx.device, **opts)
