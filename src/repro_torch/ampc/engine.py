"""``AmpcEngine`` — the port's entry point for AMPC graph solves.

    from repro_torch.ampc import AmpcEngine
    eng = AmpcEngine(dht_backend="local", epsilon=0.5, seed=0)  # on CUDA
    res = eng.solve(graph, "connectivity")
    res.output                  # int (n,) canonical component labels
    res.ledger["shuffles"]      # Table-3 materialized round count
    res.stats                   # algorithm-specific stats, stable key names

The port of the JAX package's ``repro.ampc.engine``: the engine owns the
``RoundLedger`` (one per solve, summarized on the result), the DHT backend
and the seed/epsilon defaults, and resolves problems through
:mod:`repro_torch.ampc.registry`.  It runs on ``"cuda"`` unless the caller
passes another ``device`` (the tests pass ``device="cpu"``).

Not ported yet: ``solve_many`` (ROADMAP queue 1, item 8), ``session`` and
``submit`` (step 8), the routed backend (step 9).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.rounds import RoundLedger
from ..devices import resolve_device
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import registry
from .backends import DhtBackend, resolve_backend


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
    """Uniform result of ``AmpcEngine.solve``.

    ``output`` follows the problem's declared kind: ``vertex_mask`` (bool
    (n,)), ``edge_mask`` (bool (m,)) or ``labels`` (int (n,)), as numpy
    arrays on the host.  ``ledger`` is the ``RoundLedger.summary()`` dict —
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


class AmpcEngine:
    """Session object for AMPC graph solves.

    Parameters
    ----------
    dht_backend:  ``"local"`` or a ``DhtBackend`` instance.
    epsilon:      the paper's space exponent (per-machine space n^ε).
    seed:         default randomness for rank permutations.
    trace:        ``True`` → record every solve as a span tree on a fresh
                  tracer; ``False`` → off; a ``repro_torch.obs.Tracer`` to
                  share one; ``None`` (default) → the process default.
    metrics:      a ``repro_torch.obs.MetricsRegistry``, ``False`` to
                  disable, or ``None`` (default) for the process-wide one.
    record_events: force the ``RoundLedger.events`` raw-string log on/off.
    device:       where tensors live; ``None`` means ``"cuda"``, and raises
                  when CUDA is missing.
    """

    def __init__(self, dht_backend="local", epsilon: float = 0.5,
                 seed: int = 0, *, trace=None, metrics=None,
                 record_events: Optional[bool] = None, device=None):
        self.device = resolve_device(device, "AmpcEngine")
        self.dht = resolve_backend(dht_backend)
        self.epsilon = float(epsilon)
        self.seed = int(seed)
        self.tracer = obs_trace.as_tracer(trace)
        self.metrics = obs_metrics.as_registry(metrics)
        self.record_events = record_events

    # ------------------------------------------------------------------
    def _ledger(self, spec, record_events: bool) -> RoundLedger:
        tracer = self.tracer
        return RoundLedger(
            f"{spec.model}_{spec.name}",
            tracer=tracer if tracer.enabled else None,
            metrics=self.metrics, record_events=record_events)

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

    # ------------------------------------------------------------------
    def solve(self, graph, problem: str, *, seed: Optional[int] = None,
              epsilon: Optional[float] = None,
              record_events: Optional[bool] = None, **opts) -> AmpcResult:
        """Run ``problem`` on ``graph`` and return an ``AmpcResult``.

        ``**opts`` are forwarded to the registered solver (e.g.
        ``skip_ternarize_if_dense=False`` for msf).  ``seed``/``epsilon``/
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
            device=self.device)
        tracer = self.tracer
        span = None
        t0 = time.perf_counter()
        if tracer.enabled:
            with tracer.span("solve", problem=spec.name, model=spec.model,
                             backend=self.dht.name, n=int(graph.n),
                             m=int(graph.m)) as span:
                output, stats = spec.fn(ctx, graph, **opts)
        else:
            output, stats = spec.fn(ctx, graph, **opts)
        wall = time.perf_counter() - t0
        self._observe_solve(spec, wall, "solve")
        return AmpcResult(problem=spec.name, model=spec.model,
                          backend=self.dht.name, output=output, stats=stats,
                          ledger=ledger.summary(), wall_time_s=wall,
                          raw_ledger=ledger, trace=span)

    def solve_many(self, graphs, problem: str, **kw):
        raise NotImplementedError(
            "solve_many is not ported to repro_torch yet "
            "(ROADMAP.md queue 1, item 8)")

    def session(self, graph):
        raise NotImplementedError(
            "session is not ported to repro_torch yet "
            "(ROADMAP.md queue 1, item 8)")

    def submit(self, graph, problem: str, **kw):
        raise NotImplementedError(
            "submit is not ported to repro_torch yet "
            "(ROADMAP.md queue 1, item 8)")

    def metrics_report(self) -> str:
        """Plain-text dump of this engine's metrics registry."""
        from ..obs.export import metrics_report
        return metrics_report(self.metrics)

    def problems(self, model: Optional[str] = None):
        """Names of every problem the port solves (optionally one model)."""
        return registry.names(model)

    def __repr__(self):
        return (f"AmpcEngine(dht_backend={self.dht.name!r}, "
                f"epsilon={self.epsilon}, seed={self.seed}, "
                f"device={str(self.device)!r})")
