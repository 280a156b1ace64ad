"""Karger–Klein–Tarjan sampling filter (paper Section 3.1, Algorithms 3+5).

Reduces MSF query complexity from O(m log n) to O(m + n log^2 n):

  1. sample each edge with p = 1/log n, compute F = MSF(sample);
  2. classify every edge of G as F-light / F-heavy (Definition 3.7) —
     F-heavy edges cannot be in the MSF (Proposition 3.8) and are dropped;
  3. MSF(F ∪ F-light edges) is the answer.

The port of the JAX package's ``repro.core.kkt_filter``: the Euler tour of
the forest by twin-arc successors, list ranking and depths by pointer
doubling (fixed trip counts, so no host reads), and LCA + path maximum by
binary lifting, vectorized over every query at once with the
``(levels, n)`` lifting tables.

Two departures keep the port exact where the reference is not:

  * the reference sorts arcs by ``skey * A + aid`` in int32, which wraps
    once n · 2K reaches 2^31 (K forest edges) and then yields a wrong
    forest; the port sorts ``skey`` stably, the same order wherever the
    reference's key does not wrap;
  * ``rmq_query`` takes floor(log2(length)) in float64, exact for every
    int32 length (the reference's float32 rounds 2^k - 1 up to 2^k for
    k >= 22).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..graph.coo import UGraph
from .rounds import RoundLedger

INT32_MAX = 2**31 - 1
INF = float("inf")


def _doublings(k: int) -> int:
    """Trip count of a doubling loop over k items: ceil(log2 k) + 1."""
    return int(np.ceil(np.log2(max(k, 2)))) + 1


# --------------------------------------------------------------------------
# Sparse-table RMQ (Appendix B utility)
# --------------------------------------------------------------------------
def rmq_build(a: torch.Tensor) -> torch.Tensor:
    """b[x, y] = min(a[x : x + 2^y]), as a (levels, k) table, built in
    log k steps."""
    k = a.shape[0]
    fill = INF if a.dtype.is_floating_point else INT32_MAX
    rows = [a]
    for y in range(1, max(_doublings(k), 1)):
        half = 1 << (y - 1)
        prev = rows[-1]
        shifted = torch.cat([prev[half:], torch.full(
            (half,), fill, dtype=a.dtype, device=a.device)])
        rows.append(torch.minimum(prev, shifted))
    return torch.stack(rows)


def rmq_query(table: torch.Tensor, i: torch.Tensor,
              j: torch.Tensor) -> torch.Tensor:
    """min(a[i..j]) inclusive, vectorized over query tensors."""
    length = (j - i + 1).to(torch.float64)
    t = torch.where(length > 0, torch.floor(torch.log2(length.clamp(min=1))),
                    0).long()
    i, j = i.long(), j.long()
    left = table[t, i]
    right = table[t, torch.maximum(j - (1 << t) + 1, i)]
    return torch.minimum(left, right)


# --------------------------------------------------------------------------
# Euler tour + list ranking + rooting of an unrooted forest
# --------------------------------------------------------------------------
def _segment_min(vals, seg, n_seg: int):
    """Segment minimum of int32 ``vals``; empty segments hold INT32_MAX."""
    out = torch.full((n_seg,), INT32_MAX, dtype=torch.int32,
                     device=vals.device)
    return out.scatter_reduce_(0, seg, vals, "amin")


def root_forest(fu, fv, fw, fvalid, n: int):
    """Orient a forest: returns (parent (n,), parent_w (n,), depth (n,)).

    fu/fv/fw: (K,) forest edges with validity mask.  Roots have parent=self,
    parent_w=+inf, depth=0.  The root of each tree is the first vertex of
    its lowest-numbered edge.  Euler tour construction, list ranking by
    doubling, first-entry parent extraction, depth doubling; no host reads.
    """
    dev = fu.device
    K = fu.shape[0]
    A = 2 * K  # arcs: 2e = (u->v), 2e+1 = (v->u); twin(a) = a ^ 1
    src = torch.stack([fu, fv], 1).reshape(-1)
    dst = torch.stack([fv, fu], 1).reshape(-1)
    w2 = torch.stack([fw, fw], 1).reshape(-1)
    avalid = torch.stack([fvalid, fvalid], 1).reshape(-1)
    aid = torch.arange(A, dtype=torch.int32, device=dev)

    # sort arcs by (src, arc id), invalid last: a stable sort on src, the
    # reference's int32 key src * A + aid without its wrap
    skey = torch.where(avalid, src, n)
    sorted_src, order = torch.sort(skey, stable=True)
    inv_order = torch.empty(A, dtype=torch.int64, device=dev)
    inv_order[order] = aid.long()
    start = torch.searchsorted(sorted_src, torch.arange(
        n + 1, dtype=sorted_src.dtype, device=dev))
    deg = start[1:] - start[:-1]                     # (n,) arc out-degree

    # succ(a) = cyclic-next arc (by src) after twin(a)
    twin = (aid ^ 1).long()
    t_pos = inv_order[twin]                          # position of twin
    t_src = torch.where(avalid, dst, 0).long()       # twin's src == my dst
    base = start[t_src]
    nxt_pos = base + (t_pos - base + 1) % deg[t_src].clamp(min=1)
    succ = torch.where(avalid, order[nxt_pos].to(torch.int32), aid)

    # each tree's root arc: the least arc id on its Euler cycle, found by
    # doubling along succ
    iters = _doublings(A)
    min_arc, sc = aid, succ.long()
    for _ in range(iters):
        min_arc = torch.minimum(min_arc, min_arc[sc])
        sc = sc[sc]
    is_root_arc = avalid & (min_arc == aid)

    # break the Euler cycles before the root arcs
    last = succ == aid
    succ = torch.where(is_root_arc[succ.long()] & ~last, aid, succ)

    # list ranking: d[a] = number of arcs strictly after a in its tour
    d = (succ != aid).to(torch.int32)
    p = succ.long()
    for _ in range(iters):
        d = d + d[p]
        p = p[p]
    pos = d[min_arc.long()] - d     # position within the tree; root 0

    # parent: the first arc entering v (least pos among arcs into v); the
    # tour root of each tree keeps parent = self though later arcs re-enter
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    is_tour_root = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    is_tour_root[torch.where(is_root_arc, src, n).long()] = True
    posbig = torch.where(avalid, pos, INT32_MAX)
    dsafe = torch.where(avalid, dst, n).long()
    min_pos = _segment_min(posbig, dsafe, n + 1)
    lane = torch.where(avalid & (pos <= min_pos[dsafe]), aid, INT32_MAX)
    min_lane = _segment_min(lane, dsafe, n + 1)[:n]
    has_parent = (min_lane < INT32_MAX) & ~is_tour_root[:n]
    ml = min_lane.clamp(0, max(A - 1, 0)).long()
    parent = torch.where(has_parent, src[ml], ids)
    parent_w = torch.where(has_parent, w2[ml], INF)

    # depth by parent doubling
    depth = (parent != ids).to(torch.int32)
    p = parent.long()
    for _ in range(_doublings(n)):
        depth = depth + depth[p]
        p = p[p]
    return parent, parent_w, depth


def _lift_tables(parent, parent_w, levels: int):
    """Binary lifting: anc[k][v] = 2^k-th ancestor, mx[k][v] = max edge weight
    on that jump (-inf past the root).  Returns two (levels, n) tensors."""
    n = parent.shape[0]
    ids = torch.arange(n, dtype=parent.dtype, device=parent.device)
    anc = [parent.long()]
    mx = [torch.where(parent != ids, parent_w, -INF)]
    for _ in range(1, levels):
        a_prev, m_prev = anc[-1], mx[-1]
        anc.append(a_prev[a_prev])
        mx.append(torch.maximum(m_prev, m_prev[a_prev]))
    return torch.stack(anc), torch.stack(mx)


def path_max_queries(parent, parent_w, depth, comp, qu, qv, levels: int):
    """For each query pair (qu[i], qv[i]) in the same tree: the max edge
    weight on the tree path (LCA by binary lifting), all queries at once.
    Different trees -> +inf.  Returns (maxw, same_tree)."""
    anc, mx = _lift_tables(parent, parent_w, levels)
    qu, qv = qu.long(), qv.long()
    same = comp[qu] == comp[qv]
    du, dv = depth[qu], depth[qv]
    # lift the deeper endpoint by the depth difference
    swap = du < dv
    na = torch.where(swap, qv, qu)
    nb = torch.where(swap, qu, qv)
    diff = (du - dv).abs()
    best = torch.full(qu.shape, -INF, dtype=mx.dtype, device=mx.device)
    for k in range(levels):
        take = ((diff >> k) & 1) == 1
        best = torch.where(take, torch.maximum(best, mx[k, na]), best)
        na = torch.where(take, anc[k, na], na)
    eq = na == nb
    # then both together, from the highest jump down, while they differ
    best2 = best
    for kk in range(levels - 1, -1, -1):
        differ = anc[kk, na] != anc[kk, nb]
        best2 = torch.where(differ, torch.maximum(
            best2, torch.maximum(mx[kk, na], mx[kk, nb])), best2)
        na = torch.where(differ, anc[kk, na], na)
        nb = torch.where(differ, anc[kk, nb], nb)
    final = torch.where(eq, best, torch.maximum(
        best2, torch.maximum(mx[0, na], mx[0, nb])))
    return torch.where(same, final, INF), same


# --------------------------------------------------------------------------
# F-light classification + the KKT MSF driver
# --------------------------------------------------------------------------
def f_light_edges(g: UGraph, forest_mask: np.ndarray,
                  ledger: Optional[RoundLedger] = None,
                  device="cuda") -> np.ndarray:
    """Boolean (m,) — True iff the edge is F-light w.r.t. the forest."""
    from .msf import boruvka_inround  # component labels of F
    ledger = ledger if ledger is not None else RoundLedger("f_light")
    n, m = g.n, g.m
    K = int(forest_mask.sum())
    Kp = max(K, 1)
    # an empty forest is one invalid lane, as in the reference
    fe = g.edges[forest_mask] if K else np.zeros((1, 2), np.int32)
    fw = g.weights[forest_mask] if K else np.zeros(1, np.float32)
    fu, fv, fw = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in (fe[:, 0], fe[:, 1], fw))
    fvalid = torch.full((Kp,), K > 0, dtype=torch.bool, device=device)

    with ledger.shuffle("forest_components", K * 8):
        _, comp, _ = boruvka_inround(
            fu, fv, fw, torch.arange(Kp, dtype=torch.int32, device=device),
            fvalid, n, Kp)
    with ledger.shuffle("euler_root", K * 8):
        parent, parent_w, depth = root_forest(fu, fv, fw, fvalid, n)
    levels = max(_doublings(n), 1)
    with ledger.shuffle("path_max", m * 8):
        qu = torch.from_numpy(g.edges[:, 0].copy()).to(device)
        qv = torch.from_numpy(g.edges[:, 1].copy()).to(device)
        maxw, same = ledger.harvest(path_max_queries(
            parent, parent_w, depth, comp, qu, qv, levels))
    ledger.record_queries(2 * m * levels, 2 * m * levels * 8, waves=1)
    # Definition 3.7: different components -> light; else light iff
    # w <= maxpath
    return (~same) | (g.weights <= maxw)


def msf_kkt(g: UGraph, epsilon: float = 0.5, seed: int = 0,
            ledger: Optional[RoundLedger] = None,
            device="cuda") -> Tuple[np.ndarray, dict]:
    """Algorithm 3: sample -> MSF(sample) -> F-light filter -> MSF(F ∪ light).
    Returns (mask over g.edges, stats)."""
    from ..ampc.solvers import msf_ampc
    ledger = ledger if ledger is not None else RoundLedger("ampc_msf_kkt")
    n, m = g.n, g.m
    rng = np.random.default_rng(seed)
    p = 1.0 / max(np.log(max(n, 3)), 2.0)
    with ledger.shuffle("sample", m):
        smask = rng.random(m) < p
        if not smask.any():
            smask[rng.integers(m)] = True
        h = UGraph(n, g.edges[smask], g.weights[smask])
    fmask_h, st1 = msf_ampc(h, epsilon=epsilon, seed=seed, ledger=ledger,
                            device=device)
    fmask = np.zeros(m, bool)
    fmask[np.where(smask)[0][fmask_h]] = True

    light = f_light_edges(g, fmask, ledger=ledger, device=device)
    keep = light | fmask
    g2 = UGraph(n, g.edges[keep], g.weights[keep])
    mask2, st2 = msf_ampc(g2, epsilon=epsilon, seed=seed + 1, ledger=ledger,
                          device=device)
    mask = np.zeros(m, bool)
    mask[np.where(keep)[0][mask2]] = True
    stats = {"sample_p": p, "sample_edges": int(smask.sum()),
             "forest_edges": int(fmask.sum()),
             "light_edges": int(light.sum()),
             "filtered_away": int(m - keep.sum()),
             "inner": [st1, st2]}
    return mask, stats
