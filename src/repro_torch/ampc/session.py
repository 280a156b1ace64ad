"""``GraphSession`` — DHT snapshot reuse across solves on one graph (port).

The first shuffle of every fixpoint-style AMPC solve is the same work: write
the graph's KV representation into the DHT snapshot (the rank-directed
symmetric adjacency for MIS, the edge list for the matching family).  A
serving workload that answers several queries on one graph — the paper's
"MIS then matching on one snapshot" pattern — repeats that write per solve
even though the snapshot is immutable within a session.

``engine.session(graph)`` returns a :class:`GraphSession` that materializes
the graph KV snapshot **once**, on the first solve that needs it, and lets
every later solve on the same graph hit it:

    with AmpcEngine(seed=0) as eng:        # on CUDA; device="cpu" too
        sess = eng.session(g)
        mis = sess.solve("mis")             # cold: writes the snapshot
        mm = sess.solve("matching")         # warm: skips the WriteKV shuffle
        vc = sess.solve("vertex-cover")     # warm
        mm.stats["snapshot"]                # {"hit": True, ...}

Accounting follows the :class:`~repro_torch.ampc.cache.SolverCache` model
the solver cache already uses: the snapshot store *is* a
``SolverCache`` (1 miss for the build, 1 hit per solve that reuses it),
surfaced engine-wide through ``engine.cache_info(kind="snapshot")`` and
per-solve through ``AmpcResult.stats["snapshot"]``.  A warm solve records
one fewer materialized round in its ledger (the WriteKV shuffle is the one
it skipped), which is exactly the paper's claim for snapshot reuse: the
adaptive in-round queries repeat, the shuffle does not.

Invalidation: ``session.invalidate()`` (or mutating the graph and opening a
new session) evicts the session's entries from the snapshot cache; the next
solve rebuilds.  Sessions are keyed by identity, not content — two sessions
on equal graphs build two snapshots, because the engine cannot know the
caller keeps the arrays immutable.

The snapshot is a *view-keyed* KV layout: alongside the flat graph-KV
image (``graph_kv``: symmetric adjacency + edge list, shared by ``mis``,
``matching``, ``weighted-matching``, and ``vertex-cover``) it lazily
carries the richer per-problem structures — the ternarized Δ<=3 adjacency
with ``msf``'s weight-sorted edge structure (``tern_msf``), the
unit-weight ternarization + first-slot map ``connectivity`` contracts
through (``tern_cc``), the dense-path edge/weight image (``dense_msf``),
and the cycle adjacency for ``one-vs-two`` (``cycle_adj``).
Each view is built once, under its own shuffle on the first solve that
needs it, and cached at ``(session_key, view)``; ``invalidate()`` evicts
every view of the session by key prefix.  Warm ``msf`` / ``connectivity``
solves therefore skip both the WriteGraphKV-style shuffle *and* the
per-solve ternarize rebuild: 1 materialized round instead of 2.

Problems outside :data:`SNAPSHOT_PROBLEMS` — the MPC baselines and the
multi-launch variants (``msf-mpc``, ``matching-levels``, ``msf-kkt``, …,
whose shuffle structure is per-phase, not a reusable KV image) — run
unchanged through a session; their stats report
``{"hit": False, "supported": False}``.  Alias names resolve through the
registry first, so ``"cc"`` is snapshot-aware while ``"connectivity-mpc"``
is not.

Every view's tensors live on the engine's device (the host
``TernGraph`` of a ternarized view stays on the host).  Session solves keep
the one harvest per solve (``RoundLedger.harvest``): snapshot reuse adds no
per-lookup sync.
"""
from __future__ import annotations

import itertools
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..core.one_vs_two import cycle_adjacency
from ..core.rounds import nbytes_of
from ..core.ternarize import ternarize
from ..graph.coo import UGraph
from .cache import SolverCache
from .solvers import _to

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from .engine import AmpcEngine

__all__ = ["GraphSession", "GraphSnapshot", "SNAPSHOT_PROBLEMS"]

# problems whose first shuffle writes a reusable KV view of the graph
# (flat graph-KV image, ternarized adjacency, or cycle adjacency)
SNAPSHOT_PROBLEMS = frozenset(
    {"mis", "matching", "weighted-matching", "vertex-cover",
     "msf", "connectivity", "one-vs-two"})

_session_ids = itertools.count(1)


class GraphSnapshot:
    """Lazy, cached device-side KV image of one graph.

    ``materialize(ledger)`` returns ``(entries, hit)``: the dict of device
    tensors every snapshot-aware solver reads (``sym_senders`` /
    ``sym_receivers`` for vertex fixpoints, ``edge_u`` / ``edge_v`` for
    edge fixpoints), and whether the image was already in the cache.  The
    cold build runs under a ``WriteGraphKV`` shuffle on the *calling
    solve's* ledger — the build cost is attributed to the solve that paid
    it, and warm solves record no shuffle at all.
    """

    def __init__(self, graph, key, cache: SolverCache, device):
        self.graph = graph
        self.key = key
        self.device = torch.device(device)
        self._cache = cache

    def _to(self, a) -> torch.Tensor:
        return _to(a, self.device)

    def materialize(self, ledger):
        g = self.graph

        def build():
            # one write covers both the directed-adjacency and the
            # edge-list views: a single snapshot serves MIS and the
            # matching family alike
            with ledger.shuffle("WriteGraphKV", nbytes_of(g.edges) * 3):
                s, r, _, _ = g.symmetric()
                return {
                    "sym_senders": self._to(s),
                    "sym_receivers": self._to(r),
                    "edge_u": self._to(g.edges[:, 0]),
                    "edge_v": self._to(g.edges[:, 1]),
                }

        return self._cache.get_or_build((self.key, "graph_kv"), build)

    # ------------------------------------------------------------------
    def _view(self, view: str, shuffle_name: str, nbytes: int, builder,
              ledger):
        """Build-or-hit one named KV view at ``(session_key, view)``.

        The cold build runs under ``shuffle_name`` on the calling solve's
        ledger, mirroring ``materialize``: cost lands on the solve that
        paid it, warm solves record no shuffle for the view at all.
        """
        def build():
            with ledger.shuffle(shuffle_name, nbytes):
                return builder()

        return self._cache.get_or_build((self.key, view), build)

    def materialize_tern(self, ledger, unit: bool = False):
        """Ternarized Δ<=3 adjacency view (``tern_msf`` / ``tern_cc``).

        ``unit=True`` is connectivity's variant: weights are replaced by
        the edge ids (any distinct weights do), and the view also carries
        ``first_slot`` — the first tern slot of each original vertex,
        through which component labels are read back.  The host
        ``TernGraph`` rides along as ``tg``.
        """
        g = self.graph

        def build():
            gw = (UGraph(g.n, g.edges, np.arange(g.m, dtype=np.float32))
                  if unit else g)
            tg = ternarize(gw)
            bn, bw, be = tg.g.padded_adj(3)
            entries = {
                "tg": tg,
                "nbr": self._to(bn),
                "nbw": self._to(bw),
                "nbe": self._to(be),
                "tu": self._to(tg.g.edges[:, 0]),
                "tv": self._to(tg.g.edges[:, 1]),
                "tw": self._to(tg.g.weights),
                "teid": self._to(tg.orig_eid),
            }
            if unit:
                entries["first_slot"] = self._to(np.searchsorted(
                    tg.node_of, np.arange(g.n)).astype(np.int32))
            return entries

        nbytes = (nbytes_of(g.edges) if unit
                  else nbytes_of(g.edges, g.weights))
        return self._view("tern_cc" if unit else "tern_msf",
                          "WriteTernKV", nbytes, build, ledger)

    def materialize_dense(self, ledger):
        """Dense-path MSF view (``dense_msf``): edge/weight device image."""
        g = self.graph

        def build():
            return {
                "edge_u": self._to(g.edges[:, 0]),
                "edge_v": self._to(g.edges[:, 1]),
                "edge_w": self._to(g.weights),
            }

        return self._view("dense_msf", "WriteGraphKV",
                          nbytes_of(g.edges, g.weights), build, ledger)

    def materialize_cycle(self, ledger):
        """Cycle adjacency view (``cycle_adj``) for one-vs-two."""
        g = self.graph

        def build():
            return {"cycle_nbr": self._to(cycle_adjacency(g))}

        return self._view("cycle_adj", "WriteKV",
                          nbytes_of(g.edges), build, ledger)

    def stat(self, hit: bool) -> dict:
        """The ``AmpcResult.stats["snapshot"]`` payload for one solve."""
        return {"hit": bool(hit), "key": self.key, "supported": True}


class GraphSession:
    """Multi-solve handle on one graph; see the module docstring.

    Thin by design: every solve still goes through ``engine.solve`` /
    ``engine.submit`` (same ledgers, spans, metrics, retries) — the session
    only threads the shared :class:`GraphSnapshot` into the solver and
    annotates the result stats.
    """

    def __init__(self, engine: "AmpcEngine", graph):
        self.engine = engine
        self.graph = graph
        self.key = ("snapshot", next(_session_ids))
        self.snapshot = GraphSnapshot(graph, self.key,
                                      engine._snapshot_cache, engine.device)

    # ------------------------------------------------------------------
    def _supported(self, problem: str) -> bool:
        from . import registry
        return registry.get(problem).name in SNAPSHOT_PROBLEMS

    def solve(self, problem: str, **opts):
        """``engine.solve(self.graph, problem)`` through the snapshot."""
        if self._supported(problem):
            res = self.engine.solve(self.graph, problem,
                                    snapshot=self.snapshot, **opts)
        else:
            res = self.engine.solve(self.graph, problem, **opts)
            res.stats.setdefault("snapshot",
                                 {"hit": False, "supported": False})
        return res

    def submit(self, problem: str, **opts):
        """Async variant: ``engine.submit`` with the session snapshot."""
        if self._supported(problem):
            return self.engine.submit(self.graph, problem,
                                      snapshot=self.snapshot, **opts)
        return self.engine.submit(self.graph, problem, **opts)

    # ------------------------------------------------------------------
    def invalidate(self) -> int:
        """Evict this session's snapshot; the next solve rebuilds.

        Call after mutating the graph's arrays in place.  Returns the
        number of cache entries dropped (0 if never materialized).
        """
        return self.engine._snapshot_cache.evict(self.key)

    def __repr__(self):
        return (f"GraphSession(key={self.key!r}, n={self.graph.n}, "
                f"m={self.graph.m})")
