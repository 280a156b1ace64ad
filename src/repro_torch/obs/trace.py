"""Span-based tracer: nested wall-time spans with attributes and events.

Design constraints (why this is not just ``logging``):

* **Per-solve attribution** — every ``AmpcEngine.solve`` produces one span
  tree (``AmpcResult.trace``); a ``solve_many`` bucket launch is one span
  whose per-graph children carry each graph's share of the launch, matching
  the per-graph ``RoundLedger`` attribution.
* **~zero cost when disabled** — the hot paths (``RoundLedger.shuffle``,
  ``ShardedDHT.lookup``, the batched adapters) call the tracer
  unconditionally; with the :data:`NOOP_TRACER` every call returns a shared
  singleton and allocates nothing, so a production engine with tracing off
  pays a few attribute loads per solve.
* **Thread-safe collection** — spans nest per thread (a ``threading.local``
  stack); completed root spans are appended to one shared list under a
  lock, so a threaded serving loop can trace into a single tracer.

Timestamps are microseconds since a process-wide epoch (monotonic), which
is exactly what the Chrome-trace exporter needs.

Optional device bridging: ``Tracer(annotate_device=True)`` additionally
wraps every span in a ``torch.profiler.record_function`` so the same span
names show up inside device profiles captured with ``torch.profiler``.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional

_EPOCH = time.perf_counter()


def _now_us() -> int:
    return int((time.perf_counter() - _EPOCH) * 1e6)


class SpanEvent:
    """A timestamped point event attached to a span (e.g. a WARN)."""

    __slots__ = ("name", "ts_us", "level", "attributes")

    def __init__(self, name: str, ts_us: int, level: str = "INFO",
                 attributes: Optional[Dict[str, Any]] = None):
        self.name = name
        self.ts_us = ts_us
        self.level = level
        self.attributes = attributes or {}

    def __repr__(self):
        return f"SpanEvent({self.name!r}, level={self.level!r})"


class Span:
    """One traced region: name, start/duration, attributes, children.

    Used as a context manager (``with tracer.span("phase") as sp:``); also
    produced retroactively by :meth:`Tracer.record_span` for launches whose
    duration was measured externally (the batched ``solve_many`` path).
    """

    __slots__ = ("name", "span_id", "ts_us", "dur_us", "thread_id",
                 "attributes", "events", "children", "_tracer", "_annotation")

    def __init__(self, tracer: "Tracer", name: str,
                 attributes: Optional[Dict[str, Any]] = None):
        self.name = name
        self.span_id = next(tracer._ids)
        self.ts_us = 0
        self.dur_us = 0
        self.thread_id = 0
        self.attributes = dict(attributes) if attributes else {}
        self.events: List[SpanEvent] = []
        self.children: List["Span"] = []
        self._tracer = tracer
        self._annotation = None

    # -- context manager ---------------------------------------------------
    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self.thread_id = threading.get_ident()
        if self._tracer.annotate_device:
            self._annotation = self._tracer._enter_annotation(self.name)
        self.ts_us = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur_us = _now_us() - self.ts_us
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
            self._annotation = None
        if exc_type is not None:
            self.attributes["error"] = exc_type.__name__
        self._tracer._pop(self)
        return False

    # -- mutation ----------------------------------------------------------
    def set(self, **attributes) -> "Span":
        """Attach attributes to this span; returns self for chaining."""
        self.attributes.update(attributes)
        return self

    def event(self, name: str, level: str = "INFO", **attributes) -> None:
        self.events.append(SpanEvent(name, _now_us(), level, attributes))

    # -- inspection --------------------------------------------------------
    @property
    def dur_s(self) -> float:
        return self.dur_us / 1e6

    def walk(self):
        """Yield this span and all descendants, depth-first."""
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> List["Span"]:
        """All descendant spans (incl. self) with the given name."""
        return [s for s in self.walk() if s.name == name]

    def __repr__(self):
        return (f"Span({self.name!r}, dur_us={self.dur_us}, "
                f"children={len(self.children)}, attrs={self.attributes})")


class Tracer:
    """Collects spans; one instance per engine (or per process)."""

    enabled = True

    def __init__(self, annotate_device: bool = False):
        self.annotate_device = bool(annotate_device)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._roots: List[Span] = []
        self._orphan_events: List[SpanEvent] = []
        self._local = threading.local()

    # -- span lifecycle ----------------------------------------------------
    def span(self, name: str, **attributes) -> Span:
        """Open a new span: ``with tracer.span("solve", problem="mis"):``."""
        return Span(self, name, attributes)

    def record_span(self, name: str, dur_s: float = 0.0,
                    parent: Optional[Span] = None, **attributes) -> Span:
        """Record an already-measured span retroactively.

        Used when a duration was timed externally (e.g. one batched launch
        amortized per graph).  The span ends *now* and starts ``dur_s``
        ago; it attaches under ``parent`` when given, else under the
        current open span of this thread, else as a new root.
        """
        sp = Span(self, name, attributes)
        sp.thread_id = threading.get_ident()
        sp.dur_us = int(dur_s * 1e6)
        sp.ts_us = _now_us() - sp.dur_us
        if parent is not None:
            parent.children.append(sp)
        else:
            stack = getattr(self._local, "stack", None)
            if stack:
                stack[-1].children.append(sp)
            else:
                with self._lock:
                    self._roots.append(sp)
        return sp

    def event(self, name: str, level: str = "INFO", **attributes) -> None:
        """Attach an event to the current span (or the tracer itself)."""
        stack = getattr(self._local, "stack", None)
        if stack:
            stack[-1].event(name, level=level, **attributes)
        else:
            with self._lock:
                self._orphan_events.append(
                    SpanEvent(name, _now_us(), level, attributes))

    def current_span(self) -> Optional[Span]:
        """The innermost open span on this thread, if any.

        Deferred ledger accounting (``RoundLedger.record_queries_deferred``)
        captures this span at record time and back-fills the
        ``dht_queries`` event onto it at harvest, after the span has
        closed — so traces carry each event on the span that made the
        lookup.
        """
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    # -- internals ---------------------------------------------------------
    def _push(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        if stack:
            stack[-1].children.append(span)
        stack.append(span)
        _active_stack().append(self)

    def _pop(self, span: Span) -> None:
        stack = self._local.stack
        # tolerate out-of-order exits: pop through to this span
        while stack and stack.pop() is not span:
            pass
        act = _active_stack()
        if act:
            act.pop()
        if not stack:
            with self._lock:
                self._roots.append(span)

    def _enter_annotation(self, name: str):
        from torch.profiler import record_function
        ann = record_function(name)
        ann.__enter__()
        return ann

    # -- inspection --------------------------------------------------------
    def spans(self) -> List[Span]:
        """Snapshot of completed root spans (all threads)."""
        with self._lock:
            return list(self._roots)

    def all_spans(self) -> List[Span]:
        """Flat snapshot of every completed span, depth-first."""
        return [s for root in self.spans() for s in root.walk()]

    def orphan_events(self) -> List[SpanEvent]:
        with self._lock:
            return list(self._orphan_events)

    def clear(self) -> None:
        with self._lock:
            self._roots.clear()
            self._orphan_events.clear()

    def __repr__(self):
        return f"Tracer(roots={len(self.spans())})"


class _NoopSpan:
    """Shared do-nothing span: the disabled-tracing fast path."""

    __slots__ = ()
    name = ""
    dur_us = 0
    ts_us = 0
    attributes: Dict[str, Any] = {}
    events: List[SpanEvent] = []
    children: List[Span] = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attributes):
        return self

    def event(self, name, level="INFO", **attributes):
        pass

    def walk(self):
        return iter(())

    def find(self, name):
        return []

    def __repr__(self):
        return "NoopSpan()"


class NoopTracer:
    """Tracing disabled: every method returns a shared singleton.

    ``span()`` / ``record_span()`` hand back the same ``_NoopSpan`` object,
    so instrumented hot paths allocate nothing when tracing is off.
    """

    __slots__ = ()
    enabled = False
    annotate_device = False

    def span(self, name, **attributes):
        return NOOP_SPAN

    def record_span(self, name, dur_s=0.0, parent=None, **attributes):
        return NOOP_SPAN

    def event(self, name, level="INFO", **attributes):
        pass

    def current_span(self):
        return None

    def spans(self):
        return []

    def all_spans(self):
        return []

    def orphan_events(self):
        return []

    def clear(self):
        pass

    def __repr__(self):
        return "NoopTracer()"


NOOP_SPAN = _NoopSpan()
NOOP_TRACER = NoopTracer()

# -- ambient tracer plumbing ----------------------------------------------
# current_tracer(): the tracer owning the innermost open span on this
# thread — lets deep layers with no tracer handle (e.g. runtime.retry)
# attach WARN events to whatever solve/benchmark span is running.
_ACTIVE = threading.local()

# process default: installed by harnesses so
# engines created with trace=None inherit it.
_DEFAULT: Any = NOOP_TRACER
_DEFAULT_LOCK = threading.Lock()


def _active_stack() -> list:
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    return stack


def current_tracer():
    """The tracer of the innermost open span on this thread (or no-op)."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else NOOP_TRACER


def set_default_tracer(tracer) -> None:
    """Install (or clear, with ``None``) the process-default tracer."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = tracer if tracer is not None else NOOP_TRACER


def get_default_tracer():
    return _DEFAULT


def as_tracer(spec) -> Any:
    """Resolve the engine's ``trace=`` argument to a tracer instance.

    ``None`` → the process default (no-op unless a harness installed one);
    ``True`` → a fresh :class:`Tracer`; ``False`` → the no-op tracer;
    a :class:`Tracer`/:class:`NoopTracer` instance passes through.
    """
    if spec is None:
        return get_default_tracer()
    if spec is True:
        return Tracer()
    if spec is False:
        return NOOP_TRACER
    if hasattr(spec, "span") and hasattr(spec, "enabled"):
        return spec
    raise TypeError(f"trace must be None/bool/Tracer, got {type(spec)}")
