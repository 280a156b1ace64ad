"""Engine-wide metrics: counters, gauges, histograms with labels.

A copy of the JAX package's ``repro.obs.metrics``: a deliberately small
prometheus-style registry (no external deps, no HTTP
endpoint): metrics are named, typed, and labeled; every observation is a
dict update under one lock, so recording from a threaded serving loop is
safe and cheap (~a dict lookup + add per observation).

:data:`ENGINE_METRICS` is the canonical table of every metric the engine
stack emits (the same names as the JAX package's table).

Call sites hold a :class:`MetricsRegistry` (the engine's ``metrics=`` hook,
defaulting to the process-wide :func:`default_registry`) and do::

    registry.counter("dht_queries_total", labelnames=("algorithm",)) \\
            .inc(42, algorithm="ampc_mis")
    registry.histogram("solve_latency_s",
                       labelnames=("problem", "backend")) \\
            .observe(0.012, problem="mis", backend="local")
    print(registry.report())
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
from typing import Dict, Optional, Tuple

# -----------------------------------------------------------------------
# Canonical metric table.
# -----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MetricDef:
    name: str
    kind: str                    # "counter" | "gauge" | "histogram"
    labels: Tuple[str, ...]
    help: str


ENGINE_METRICS: Dict[str, MetricDef] = {m.name: m for m in [
    MetricDef("solve_latency_s", "histogram", ("problem", "backend"),
              "end-to-end wall time of one solve (per graph in solve_many)"),
    MetricDef("solves_total", "counter", ("problem", "backend", "mode"),
              "engine solves served; mode=solve|solve_many"),
    MetricDef("shuffles_total", "counter", ("algorithm",),
              "materialized rounds recorded by RoundLedgers"),
    MetricDef("bytes_shuffled_total", "counter", ("algorithm",),
              "bytes written by materialized rounds"),
    MetricDef("dht_queries_total", "counter", ("algorithm",),
              "KV lookups issued against DHT snapshots (post-dedup)"),
    MetricDef("dht_bytes_total", "counter", ("algorithm",),
              "query + answer bytes on the DHT"),
    MetricDef("dht_query_waves_total", "counter", ("algorithm",),
              "adaptive query waves inside launches"),
    MetricDef("dedup_savings_total", "counter", ("algorithm",),
              "queries avoided by the per-machine caching optimization"),
    MetricDef("dht_overflows_total", "counter", ("algorithm",),
              "routed-router capacity overflows (0 = exact answers)"),
    MetricDef("solver_cache_hits_total", "counter", (),
              "graphs served by an already-traced batched solver"),
    MetricDef("solver_cache_misses_total", "counter", (),
              "batched solvers actually traced/compiled"),
    MetricDef("retry_transients_total", "counter", ("marker",),
              "transient launch failures retried by runtime.retry"),
    MetricDef("engine_async_submitted_total", "counter", ("problem",),
              "futures accepted by AmpcEngine.submit"),
    MetricDef("engine_async_cancelled_total", "counter", ("problem",),
              "futures cancelled before their solve started"),
    MetricDef("engine_async_inflight", "gauge", (),
              "submitted futures not yet resolved (0 when the pool is idle)"),
]}


# -----------------------------------------------------------------------
# Metric types
# -----------------------------------------------------------------------
class _Metric:
    kind = ""

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._values: Dict[Tuple, float] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} expects labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def collect(self) -> Dict[Tuple, float]:
        with self._lock:
            return dict(self._values)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, value: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value


DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, float("inf"))


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        b = tuple(sorted(buckets))
        if not b or b[-1] != float("inf"):
            b = b + (float("inf"),)
        self.buckets = b
        # per label-key: [count, sum, per-bucket cumulative-style counts]
        self._hist: Dict[Tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = [0, 0.0, [0] * len(self.buckets)]
            h[0] += 1
            h[1] += value
            h[2][idx] += 1
            self._values[key] = h[1]      # collect() → sum, like counters

    def stats(self, **labels) -> Dict[str, float]:
        with self._lock:
            h = self._hist.get(self._key(labels))
            if h is None:
                return {"count": 0, "sum": 0.0, "mean": 0.0}
            return {"count": h[0], "sum": h[1], "mean": h[1] / max(h[0], 1)}

    def collect_hist(self) -> Dict[Tuple, dict]:
        with self._lock:
            return {k: {"count": h[0], "sum": h[1],
                        "buckets": dict(zip(self.buckets, h[2]))}
                    for k, h in self._hist.items()}


# -----------------------------------------------------------------------
# Registry
# -----------------------------------------------------------------------
class MetricsRegistry:
    """Named, typed, labeled metrics under one lock.

    ``counter``/``gauge``/``histogram`` are get-or-create: repeated calls
    with the same name return the same metric (and raise on a kind or
    labelnames mismatch, so two call sites cannot silently diverge).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Tuple[str, ...], **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames,
                                              self._lock, **kw)
                return m
        if not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m.kind}, not {cls.kind}")
        if m.labelnames != tuple(labelnames):
            raise ValueError(f"metric {name!r} labelnames {m.labelnames} != "
                             f"{tuple(labelnames)}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Tuple[str, ...] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Tuple[str, ...] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Tuple[str, ...] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    # -- inspection --------------------------------------------------------
    def metrics(self) -> Dict[str, _Metric]:
        with self._lock:
            return dict(self._metrics)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """``{metric: {"label=a,label2=b": value}}`` snapshot."""
        out = {}
        for name, m in sorted(self.metrics().items()):
            series = {}
            for key, val in sorted(m.collect().items()):
                label = ",".join(f"{k}={v}"
                                 for k, v in zip(m.labelnames, key))
                series[label] = val
            out[name] = series
        return out

    def report(self) -> str:
        """Plain-text report (the ``engine.metrics_report()`` payload)."""
        lines = []
        for name, m in sorted(self.metrics().items()):
            head = f"# {m.kind} {name}"
            if m.help:
                head += f" — {m.help}"
            lines.append(head)
            if isinstance(m, Histogram):
                for key, h in sorted(m.collect_hist().items()):
                    labels = _fmt_labels(m.labelnames, key)
                    mean = h["sum"] / max(h["count"], 1)
                    lines.append(f"{name}{labels}  count={h['count']} "
                                 f"sum={h['sum']:.6g} mean={mean:.6g}")
            else:
                for key, val in sorted(m.collect().items()):
                    v = int(val) if float(val).is_integer() else val
                    lines.append(f"{name}{_fmt_labels(m.labelnames, key)}  "
                                 f"{v}")
        return "\n".join(lines) if lines else "(no metrics recorded)"

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def __repr__(self):
        return f"MetricsRegistry(metrics={sorted(self.metrics())})"


def _fmt_labels(names: Tuple[str, ...], key: Tuple) -> str:
    if not names:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in zip(names, key)) + "}"


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (engine default; runtime.retry reports
    here too, so one report covers the whole stack)."""
    return _DEFAULT


def as_registry(spec) -> Optional[MetricsRegistry]:
    """Resolve the engine's ``metrics=`` argument.

    ``None`` → :func:`default_registry`; ``False`` → metrics disabled
    (``None``); a :class:`MetricsRegistry` passes through.
    """
    if spec is None:
        return default_registry()
    if spec is False:
        return None
    if isinstance(spec, MetricsRegistry):
        return spec
    raise TypeError(f"metrics must be None/False/MetricsRegistry, "
                    f"got {type(spec)}")
