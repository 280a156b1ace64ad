"""Trace/metrics exporters: Chrome-trace JSON, JSONL, plain text.

* :func:`to_chrome_trace` — the Trace Event Format consumed by
  ``chrome://tracing`` and https://ui.perfetto.dev: complete events
  (``ph="X"`` with ``ts``/``dur`` in microseconds) for spans, instant
  events (``ph="i"``) for span events, and ``ph="M"`` metadata records.
* :func:`write_jsonl` — one JSON object per span (flat, parent-linked),
  for ad-hoc ``jq``/pandas analysis of engine timelines.
* :func:`metrics_report` — plain-text registry dump
  (``engine.metrics_report()`` delegates here).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterable, List, Optional

from .trace import Span


def _roots(tracer_or_spans) -> List[Span]:
    if hasattr(tracer_or_spans, "spans"):
        return tracer_or_spans.spans()
    return list(tracer_or_spans)


def iter_spans(tracer_or_spans) -> Iterable[Span]:
    """Every span (roots + descendants), depth-first."""
    for root in _roots(tracer_or_spans):
        yield from root.walk()


def _args(attrs: Dict[str, Any]) -> Dict[str, Any]:
    # Chrome trace args must be JSON-serializable; stringify anything fancy
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)
    return out


def to_chrome_trace(tracer_or_spans, *, pid: Optional[int] = None,
                    extra_meta: Optional[Dict[str, Any]] = None) -> dict:
    """Render spans as a Chrome-trace (Perfetto-loadable) JSON object.

    Returns ``{"traceEvents": [...], "displayTimeUnit": "ms", ...meta}``;
    pass the result to ``json.dump`` or use :func:`write_chrome_trace`.
    """
    pid = os.getpid() if pid is None else pid
    events: List[dict] = []
    tids = set()
    for sp in iter_spans(tracer_or_spans):
        tid = sp.thread_id or 0
        tids.add(tid)
        events.append({
            "name": sp.name, "ph": "X", "ts": sp.ts_us, "dur": sp.dur_us,
            "pid": pid, "tid": tid, "cat": "span",
            "args": _args(sp.attributes),
        })
        for ev in sp.events:
            events.append({
                "name": ev.name, "ph": "i", "ts": ev.ts_us, "pid": pid,
                "tid": tid, "s": "t", "cat": ev.level,
                "args": _args(ev.attributes),
            })
    if hasattr(tracer_or_spans, "orphan_events"):
        for ev in tracer_or_spans.orphan_events():
            events.append({"name": ev.name, "ph": "i", "ts": ev.ts_us,
                           "pid": pid, "tid": 0, "s": "p", "cat": ev.level,
                           "args": _args(ev.attributes)})
    main_tid = threading.main_thread().ident
    for tid in sorted(tids):
        label = "main" if tid == main_tid else f"thread-{tid}"
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": label}})
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if extra_meta:
        doc["otherData"] = dict(extra_meta)
    return doc


def write_chrome_trace(path: str, tracer_or_spans, *,
                       extra_meta: Optional[Dict[str, Any]] = None) -> dict:
    """Write the Chrome-trace JSON to ``path``; returns the document."""
    doc = to_chrome_trace(tracer_or_spans, extra_meta=extra_meta)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def span_to_dict(sp: Span, parent_id: Optional[int] = None) -> dict:
    return {
        "span_id": sp.span_id, "parent_id": parent_id, "name": sp.name,
        "ts_us": sp.ts_us, "dur_us": sp.dur_us, "thread_id": sp.thread_id,
        "attributes": _args(sp.attributes),
        "events": [{"name": ev.name, "ts_us": ev.ts_us, "level": ev.level,
                    "attributes": _args(ev.attributes)} for ev in sp.events],
    }


def write_jsonl(path: str, tracer_or_spans) -> int:
    """Write one JSON object per span; returns the number of lines."""
    n = 0
    with open(path, "w") as f:
        stack = [(root, None) for root in reversed(_roots(tracer_or_spans))]
        while stack:
            sp, parent_id = stack.pop()
            f.write(json.dumps(span_to_dict(sp, parent_id)) + "\n")
            n += 1
            for c in reversed(sp.children):
                stack.append((c, sp.span_id))
    return n


def coverage(tracer_or_spans, wall_us: float) -> float:
    """Fraction of ``wall_us`` covered by root spans (for the ≥95% gate)."""
    covered = sum(sp.dur_us for sp in _roots(tracer_or_spans))
    return covered / wall_us if wall_us > 0 else 0.0


def metrics_report(registry) -> str:
    """Plain-text metrics dump (``None``-safe)."""
    if registry is None:
        return "(metrics disabled)"
    return registry.report()
