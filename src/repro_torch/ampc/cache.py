"""Engine-level solver cache (torch port of ``repro.ampc.cache``).

Eager torch traces nothing, so what ``SolverCache`` memoizes here is the
bucket's solver callable: a closure over the bucket shape and any static
budget, keyed per ``(problem, backend, bucket)``.  The hit and miss
accounting is the reference's, so ``AmpcEngine.cache_info()`` reads the
same counts as the JAX engine's.

Accounting model: one *miss* per solver actually built; one *hit* per graph
that reuses an already-built solver.  A bucket launch over ``B`` graphs on a
cold key therefore records 1 miss + ``B - 1`` hits; on a warm key it records
``B`` hits.  The counters surface per solve on
``AmpcResult.stats["solver_cache"]`` and engine-wide through
``AmpcEngine.cache_info()``.  The engine's ``GraphSession`` snapshot store
is a second ``SolverCache`` (``cache_info("snapshot")``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Hashable, Tuple


@dataclasses.dataclass(frozen=True)
class CacheInfo:
    """Snapshot of cache effectiveness (mirrors ``functools.lru_cache``)."""

    hits: int
    misses: int
    size: int

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class SolverCache:
    """Thread-safe memo of batched solvers keyed by bucket.

    Keys are arbitrary hashables; the engine uses
    ``(problem, backend_name, n_bucket, m_bucket, extra...)`` where
    ``extra`` captures any option the solver closes over (e.g. the
    walk budget of one-vs-two).
    """

    def __init__(self, metrics=None):
        self._store: Dict[Hashable, Any] = {}
        self._hits = 0
        self._misses = 0
        self._lock = threading.Lock()
        self.metrics = metrics  # obs.MetricsRegistry or None

    def _report(self, hits: int, misses: int) -> None:
        m = self.metrics
        if m is None:
            return
        if hits:
            m.counter("solver_cache_hits_total").inc(hits)
        if misses:
            m.counter("solver_cache_misses_total").inc(misses)

    def get_or_build(self, key: Hashable, builder: Callable[[], Any],
                     occupants: int = 1) -> Tuple[Any, bool]:
        """Return ``(solver, was_cached)`` for ``key``.

        ``occupants`` is the number of graphs riding this launch; all of
        them except the one paying a fresh build count as hits.
        """
        with self._lock:
            cached = self._store.get(key)
            if cached is not None:
                self._hits += occupants
        if cached is not None:
            self._report(occupants, 0)
            return cached, True
        solver = builder()  # build outside the lock: a build can be slow
        with self._lock:
            cached = self._store.get(key)
            if cached is not None:  # lost a race; the built copy is discarded
                self._hits += occupants
            else:
                self._store[key] = solver
                self._misses += 1
                self._hits += max(occupants - 1, 0)
        if cached is not None:
            self._report(occupants, 0)
            return cached, True
        self._report(max(occupants - 1, 0), 1)
        return solver, False

    def info(self) -> CacheInfo:
        with self._lock:
            return CacheInfo(hits=self._hits, misses=self._misses,
                             size=len(self._store))

    def keys(self):
        with self._lock:
            return sorted(self._store, key=repr)

    def evict(self, prefix: Hashable) -> int:
        """Drop every entry whose key equals ``prefix`` or is a tuple
        starting with it (``GraphSession.invalidate`` evicts all views of
        one snapshot this way).  Counters are kept — eviction is not a
        reset.  Returns the number of entries dropped."""
        with self._lock:
            doomed = [k for k in self._store
                      if k == prefix
                      or (isinstance(k, tuple) and k and k[0] == prefix)]
            for k in doomed:
                del self._store[k]
            return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self._hits = 0
            self._misses = 0
