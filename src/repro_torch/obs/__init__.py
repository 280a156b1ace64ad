"""Observability for the port's AMPC engine: tracing, metrics, exporters.

Pure-Python copies of the JAX package's ``repro.obs`` layers (the device
bridge of :class:`Tracer` uses ``torch.profiler.record_function``):

* :mod:`repro_torch.obs.trace`   — span-based tracer;
* :mod:`repro_torch.obs.metrics` — metrics registry and ``ENGINE_METRICS``;
* :mod:`repro_torch.obs.export`  — Chrome-trace JSON, JSONL, text reports.
"""
from .trace import (NOOP_TRACER, Span, SpanEvent, Tracer, as_tracer,
                    current_tracer, get_default_tracer, set_default_tracer)
from .metrics import (ENGINE_METRICS, MetricDef, MetricsRegistry,
                      default_registry)
from .export import (coverage, iter_spans, metrics_report, to_chrome_trace,
                     write_chrome_trace, write_jsonl)

__all__ = [
    "Tracer", "Span", "SpanEvent", "NOOP_TRACER", "as_tracer",
    "current_tracer", "get_default_tracer", "set_default_tracer",
    "MetricsRegistry", "MetricDef", "ENGINE_METRICS", "default_registry",
    "to_chrome_trace", "write_chrome_trace", "write_jsonl", "iter_spans",
    "metrics_report", "coverage",
]
