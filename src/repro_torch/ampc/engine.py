"""``AmpcEngine`` — the port's entry point for AMPC graph solves.

    from repro_torch.ampc import AmpcEngine
    eng = AmpcEngine(dht_backend="local", epsilon=0.5, seed=0)  # on CUDA
    res = eng.solve(graph, "connectivity")
    res.output                  # int (n,) canonical component labels
    res.ledger["shuffles"]      # Table-3 materialized round count
    res.stats                   # algorithm-specific stats, stable key names

The port of the JAX package's ``repro.ampc.engine``: the engine owns the
``RoundLedger`` (one per solve, summarized on the result; deferred, with
one harvest a solve, unless ``deferred_accounting=False``), the DHT backend
(the local gather or the all-to-all router, with the same accounting) and
the seed/epsilon defaults, and resolves problems through
:mod:`repro_torch.ampc.registry`.  It runs on ``"cuda"`` unless the caller
passes another ``device`` (the tests pass ``device="cpu"``).

The serving layers come with it, as in the reference:

  * :meth:`AmpcEngine.solve_many` pads a fleet into power-of-two shape
    buckets and runs each bucket as one eager loop over its
    offset-flattened graphs, memoizing the bucket's solver per
    ``(problem, backend, bucket)`` in a
    :class:`~repro_torch.ampc.cache.SolverCache` (:meth:`cache_info`);
  * :meth:`AmpcEngine.session` returns a
    :class:`~repro_torch.ampc.session.GraphSession` whose solves share one
    cached DHT snapshot of the graph;
  * ``submit`` / ``submit_many`` / ``shutdown``
    (:mod:`repro_torch.ampc.async_engine`) serve solves from a bounded
    worker pool, with device work serialized by one launch lock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.rounds import RoundLedger
from ..devices import resolve_device
from ..graph import batching
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import registry
from .async_engine import AsyncEngineMixin
from .backends import DhtBackend, resolve_backend
from .cache import CacheInfo, SolverCache
from .session import GraphSession


def _field_eq(a, b) -> bool:
    """Equality that tolerates numpy arrays nested in outputs/stats."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and \
            all(_field_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and \
            all(_field_eq(x, y) for x, y in zip(a, b))
    return a == b


@dataclasses.dataclass(eq=False)
class AmpcResult:
    """Uniform result of ``AmpcEngine.solve`` / ``AmpcEngine.solve_many``.

    ``output`` follows the problem's declared kind: ``vertex_mask`` (bool
    (n,)), ``edge_mask`` (bool (m,)) or ``labels`` (int (n,)), as numpy
    arrays on the host, or ``count`` (a Python int: the number of cycles
    for ``one-vs-two``).  ``ledger`` is the ``RoundLedger.summary()`` dict —
    ``ledger["shuffles"]`` is the paper's Table-3 round count.
    ``raw_ledger`` and ``trace`` are excluded from equality.
    """

    problem: str
    model: str                      # "ampc" | "mpc"
    backend: str                    # DHT backend name used for the solve
    output: Any
    stats: Dict[str, Any]
    ledger: Dict[str, Any]
    wall_time_s: float
    raw_ledger: Optional[RoundLedger] = dataclasses.field(
        repr=False, compare=False, default=None)
    trace: Optional[Any] = dataclasses.field(
        repr=False, compare=False, default=None)

    @property
    def shuffles(self) -> int:
        return self.ledger["shuffles"]

    def __eq__(self, other):
        if not isinstance(other, AmpcResult):
            return NotImplemented
        return all(_field_eq(getattr(self, f.name), getattr(other, f.name))
                   for f in dataclasses.fields(self) if f.compare)

    def __repr__(self):
        return (f"AmpcResult(problem={self.problem!r}, model={self.model!r}, "
                f"backend={self.backend!r}, shuffles={self.shuffles}, "
                f"dht_queries={self.ledger['dht_queries']}, "
                f"wall_time_s={self.wall_time_s:.3f})")


@dataclasses.dataclass
class SolveContext:
    """Cross-cutting state handed to every registered solver."""

    ledger: RoundLedger
    dht: DhtBackend
    seed: int
    epsilon: float
    device: torch.device
    mesh: Any = None


@dataclasses.dataclass
class BatchSolveContext:
    """Cross-cutting state handed to a batch adapter for one bucket launch.

    ``ledgers`` holds one ``RoundLedger`` per graph in the batch (batch
    order): the single physical launch is attributed per graph — each ledger
    records the bucket's shuffle structure with that graph's own bytes and
    its own share of the DHT query counts (split by mask).
    """

    ledgers: List[RoundLedger]
    dht: DhtBackend
    seed: int
    epsilon: float
    cache: SolverCache
    device: torch.device
    problem: str = ""
    backend_name: str = ""
    mesh: Any = None

    def solver_key(self, batch, *extra):
        """Cache key for this bucket's solver.  ``extra`` captures options
        the solver closes over (e.g. a walk budget)."""
        return (self.problem, self.backend_name,
                batch.n_bucket, batch.m_bucket, *extra)


class AmpcEngine(AsyncEngineMixin):
    """Session object for AMPC graph solves.

    Parameters
    ----------
    mesh:         a ``repro_torch.core.dht.DhtMesh`` handed to the routed
                  backend (one shard a device of the values' kind when
                  omitted).
    dht_backend:  ``"local"`` | ``"routed"`` | a ``DhtBackend`` instance.
    epsilon:      the paper's space exponent (per-machine space n^ε).
    seed:         default randomness for rank permutations.
    trace:        ``True`` → record every solve as a span tree on a fresh
                  tracer; ``False`` → off; a ``repro_torch.obs.Tracer`` to
                  share one; ``None`` (default) → the process default.
    metrics:      a ``repro_torch.obs.MetricsRegistry``, ``False`` to
                  disable, or ``None`` (default) for the process-wide one.
    record_events: force the ``RoundLedger.events`` raw-string log on/off;
                  ``None`` (default) keeps it on for ``solve`` and off
                  inside ``solve_many`` bucket loops.
    device:       where tensors live; ``None`` means ``"cuda"``, and raises
                  when CUDA is missing.
    max_workers:  size of the async worker pool behind ``engine.submit``
                  (lazy: no threads exist until the first submit).
    queue_depth:  bound on the submit queue before ``submit`` blocks for
                  backpressure; default ``2 * max_workers``.
    serialize_launches: hold one engine-wide lock around every solve's and
                  bucket's device work, so concurrent async solves overlap
                  host-side phases but never race on the device.
    deferred_accounting: ``True`` (default) → per-solve ledgers queue DHT
                  counters on the device and a solve makes one
                  device-to-host harvest (one a ``solve_many`` bucket);
                  ``False`` → eager ledgers: every lookup copies its counts
                  to the host at once, and a harvest copies leaf by leaf.
                  Outputs and counters are the same either way.
    """

    def __init__(self, mesh=None, dht_backend="local", epsilon: float = 0.5,
                 seed: int = 0, *, trace=None, metrics=None,
                 record_events: Optional[bool] = None, device=None,
                 max_workers: int = 4, queue_depth: Optional[int] = None,
                 serialize_launches: bool = True,
                 deferred_accounting: bool = True):
        self.device = resolve_device(device, "AmpcEngine")
        self.mesh = mesh
        self.dht = resolve_backend(dht_backend, mesh=mesh)
        self.epsilon = float(epsilon)
        self.seed = int(seed)
        self.deferred_accounting = bool(deferred_accounting)
        self.tracer = obs_trace.as_tracer(trace)
        self.metrics = obs_metrics.as_registry(metrics)
        self.record_events = record_events
        self._solver_cache = SolverCache(metrics=self.metrics)
        # snapshot store for GraphSessions; separate from the solver cache
        # so solver hit/miss accounting stays comparable across versions
        self._snapshot_cache = SolverCache()
        self._launch_lock = (threading.RLock() if serialize_launches
                             else contextlib.nullcontext())
        self._init_async(max_workers, queue_depth)

    # ------------------------------------------------------------------
    def _ledger(self, spec, record_events: bool) -> RoundLedger:
        tracer = self.tracer
        return RoundLedger(
            f"{spec.model}_{spec.name}",
            tracer=tracer if tracer.enabled else None,
            metrics=self.metrics, record_events=record_events,
            deferred=self.deferred_accounting)

    def _observe_solve(self, spec, wall: float, mode: str) -> None:
        m = self.metrics
        if m is None:
            return
        m.histogram("solve_latency_s",
                    labelnames=("problem", "backend")).observe(
                        wall, problem=spec.name, backend=self.dht.name)
        m.counter("solves_total",
                  labelnames=("problem", "backend", "mode")).inc(
                      1, problem=spec.name, backend=self.dht.name, mode=mode)

    def _validate(self, spec, graph) -> None:
        if spec.needs_weights and getattr(graph, "weights", None) is None:
            raise ValueError(
                f"problem {spec.name!r} needs edge weights; call "
                "g.with_random_weights()/g.with_degree_weights() first")
        if spec.needs_cycles and not (graph.degrees() == 2).all():
            raise ValueError(
                f"problem {spec.name!r} needs a disjoint union of cycles "
                "(every vertex must have degree 2)")

    # ------------------------------------------------------------------
    def solve(self, graph, problem: str, *, seed: Optional[int] = None,
              epsilon: Optional[float] = None,
              record_events: Optional[bool] = None, **opts) -> AmpcResult:
        """Run ``problem`` on ``graph`` and return an ``AmpcResult``.

        ``**opts`` are forwarded to the registered solver (e.g.
        ``skip_ternarize_if_dense=False`` for msf, ``p=1/64`` for
        one-vs-two).  ``seed``/``epsilon``/
        ``record_events`` override the engine defaults for this solve.
        """
        spec = registry.get(problem)
        self._validate(spec, graph)
        if record_events is None:
            record_events = self.record_events
        ledger = self._ledger(spec, True if record_events is None
                              else record_events)
        ctx = SolveContext(
            ledger=ledger, dht=self.dht,
            seed=self.seed if seed is None else int(seed),
            epsilon=self.epsilon if epsilon is None else float(epsilon),
            device=self.device, mesh=self.mesh)
        tracer = self.tracer
        span = None
        t0 = time.perf_counter()
        # the launch lock serializes device work across async workers; the
        # wait for it is part of the solve span (device-contention time)
        if tracer.enabled:
            with tracer.span("solve", problem=spec.name, model=spec.model,
                             backend=self.dht.name, n=int(graph.n),
                             m=int(graph.m)) as span:
                with self._launch_lock:
                    output, stats = spec.fn(ctx, graph, **opts)
        else:
            with self._launch_lock:
                output, stats = spec.fn(ctx, graph, **opts)
        wall = time.perf_counter() - t0
        self._observe_solve(spec, wall, "solve")
        return AmpcResult(problem=spec.name, model=spec.model,
                          backend=self.dht.name, output=output, stats=stats,
                          ledger=ledger.summary(), wall_time_s=wall,
                          raw_ledger=ledger, trace=span)

    # ------------------------------------------------------------------
    def solve_many(self, graphs: Sequence[Any], problem: str, *,
                   seed: Optional[int] = None,
                   epsilon: Optional[float] = None,
                   record_events: Optional[bool] = None,
                   **opts) -> List[AmpcResult]:
        """Solve ``problem`` on a fleet of graphs, one result per graph.

        Graphs are padded into power-of-two ``(n_bucket, m_bucket)`` shape
        buckets (:mod:`repro_torch.graph.batching`); each bucket runs as one
        eager loop over its offset-flattened graphs, with one harvest, and
        its solver is memoized in the engine's :class:`SolverCache`.
        Outputs equal sequential ``solve`` outputs; ``wall_time_s`` is the
        bucket launch amortized over its occupants.

        Bucket-loop ledgers default to ``record_events=False``.  With
        tracing enabled each bucket launch is one ``bucket`` span whose
        per-graph ``graph[i]`` children carry that graph's ledger
        attribution; ``result.trace`` points at the graph's own span.

        Problems without a registered batch adapter fall back to sequential
        ``solve`` calls — same results, no batching.
        """
        graphs = list(graphs)
        spec = registry.get(problem)
        for g in graphs:
            self._validate(spec, g)
        if record_events is None:
            record_events = self.record_events
        rec = False if record_events is None else record_events
        if spec.batch_fn is None:
            return [self.solve(g, problem, seed=seed, epsilon=epsilon,
                               record_events=rec, **opts)
                    for g in graphs]
        tracer = self.tracer
        results: List[Optional[AmpcResult]] = [None] * len(graphs)
        root = tracer.span("solve_many", problem=spec.name,
                           backend=self.dht.name, n_graphs=len(graphs)) \
            if tracer.enabled else contextlib.nullcontext()
        with root:
            for batch in batching.bucketize(graphs).values():
                self._solve_bucket(spec, batch, results, rec,
                                   seed=seed, epsilon=epsilon, **opts)
        return results

    def _solve_bucket(self, spec, batch, results, rec, *, seed, epsilon,
                      **opts) -> None:
        """One bucket launch of ``solve_many``: run, attribute, trace."""
        tracer = self.tracer
        # tracer=None on bucket ledgers: one physical launch must not emit
        # B copies of every shuffle span — the per-graph share is attached
        # afterwards, from each ledger's phase_times.
        ledgers = [RoundLedger(f"{spec.model}_{spec.name}",
                               metrics=self.metrics, record_events=rec,
                               deferred=self.deferred_accounting)
                   for _ in range(len(batch))]
        bctx = BatchSolveContext(
            ledgers=ledgers, dht=self.dht,
            seed=self.seed if seed is None else int(seed),
            epsilon=self.epsilon if epsilon is None else float(epsilon),
            cache=self._solver_cache, device=self.device,
            problem=spec.name, backend_name=self.dht.name, mesh=self.mesh)
        bspan = tracer.span(
            "bucket", problem=spec.name, n_bucket=batch.n_bucket,
            m_bucket=batch.m_bucket, batch_size=len(batch)) \
            if tracer.enabled else None
        t0 = time.perf_counter()
        with bspan if bspan is not None else contextlib.nullcontext():
            with self._launch_lock:
                outs = spec.batch_fn(bctx, batch, **opts)
        wall = time.perf_counter() - t0
        if len(outs) != len(batch):
            raise RuntimeError(
                f"batch adapter for {spec.name!r} returned {len(outs)} "
                f"results for {len(batch)} graphs")
        per_graph_wall = wall / max(len(batch), 1)
        for slot, (idx, (output, stats)) in enumerate(
                zip(batch.indices, outs)):
            stats.setdefault("batch", {
                "bucket": batch.key, "batch_size": len(batch),
                "slot": slot})
            ledger = ledgers[slot]
            gspan = None
            if bspan is not None:
                gspan = tracer.record_span(
                    f"graph[{idx}]", dur_s=per_graph_wall, parent=bspan,
                    problem=spec.name, bucket=batch.key, slot=slot)
                for phase, secs in ledger.phase_times.items():
                    tracer.record_span(f"shuffle:{phase}", dur_s=secs,
                                       parent=gspan,
                                       algorithm=ledger.algorithm)
            self._observe_solve(spec, per_graph_wall, "solve_many")
            results[idx] = AmpcResult(
                problem=spec.name, model=spec.model,
                backend=self.dht.name, output=output, stats=stats,
                ledger=ledger.summary(),
                wall_time_s=per_graph_wall, raw_ledger=ledger,
                trace=gspan)

    # ------------------------------------------------------------------
    def session(self, graph) -> GraphSession:
        """A :class:`~repro_torch.ampc.session.GraphSession` on ``graph``:
        solves through it share one DHT graph-KV snapshot (built on first
        use, on this engine's device, reported in
        ``AmpcResult.stats["snapshot"]``)."""
        return GraphSession(self, graph)

    def cache_info(self, kind: str = "solver") -> CacheInfo:
        """Hit/miss/size counters of an engine cache.

        ``kind="solver"`` (default): the bucket-solver cache — one miss per
        solver built; one hit per graph served by an already-built solver
        (so a cold bucket of ``B`` graphs counts ``1`` miss and ``B - 1``
        hits).  ``kind="snapshot"``: the GraphSession snapshot store — one
        miss per snapshot view built, one hit per solve that reused one.
        """
        if kind == "solver":
            return self._solver_cache.info()
        if kind == "snapshot":
            return self._snapshot_cache.info()
        raise ValueError(
            f"kind must be 'solver' or 'snapshot', got {kind!r}")

    def clear_cache(self) -> None:
        """Drop every memoized solver and graph snapshot, and reset both
        caches' hit/miss counters."""
        self._solver_cache.clear()
        self._snapshot_cache.clear()

    def metrics_report(self) -> str:
        """Plain-text dump of this engine's metrics registry."""
        from ..obs.export import metrics_report
        return metrics_report(self.metrics)

    def problems(self, model: Optional[str] = None):
        """Names of every solvable problem (optionally one model only)."""
        return registry.names(model)

    def baseline_for(self, problem: str) -> Optional[str]:
        """Name of the MPC baseline registered for an AMPC problem."""
        for spec in registry.specs("mpc"):
            if spec.baseline_of == registry.get(problem).name:
                return spec.name
        return None

    def __repr__(self):
        return (f"AmpcEngine(dht_backend={self.dht.name!r}, "
                f"epsilon={self.epsilon}, seed={self.seed}, "
                f"device={str(self.device)!r})")
