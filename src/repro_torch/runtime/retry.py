"""Resilient execution of device launches (torch port of
``repro.runtime.retry``).

A launch that fails with a transient runtime error is retried, the same
recovery path a production runner takes after losing a worker mid-step
(re-execute from the last materialized round).  Repeated failure surfaces
the original error.  The markers and the ``except ValueError`` are the
reference's: the port adds no net for CUDA errors, out-of-memory errors
included.

Every retry is observable, not just logged: it increments
``retry_transients_total{marker}`` on the process metrics registry
(:func:`repro_torch.obs.metrics.default_registry`) and attaches a
WARN-level ``transient_retry`` event to whatever span is currently open
(the enclosing solve), so retries show up inline in exported timelines.
"""
from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any, Callable, List, Optional

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

log = logging.getLogger(__name__)

_TRANSIENT_MARKERS = (
    "buffers but compiled program expected",   # XLA CPU re-execution bug
    "RESOURCE_EXHAUSTED",
    "preempted",
)


def transient_marker(err: Exception) -> Optional[str]:
    """The first transient marker matching ``err``, or None."""
    msg = str(err)
    for marker in _TRANSIENT_MARKERS:
        if marker in msg:
            return marker
    return None


def is_transient(err: Exception) -> bool:
    return transient_marker(err) is not None


def _observe_retry(marker: str, attempt: int, retries: int,
                   err: Exception) -> None:
    obs_metrics.default_registry().counter(
        "retry_transients_total", labelnames=("marker",)).inc(1,
                                                              marker=marker)
    obs_trace.current_tracer().event(
        "transient_retry", level="WARN", marker=marker, attempt=attempt,
        retries=retries, error=str(err)[:200])


class _FaultPlan:
    """One armed injection: fail the next ``times`` resilient calls."""

    def __init__(self, marker: str, times: int):
        self.marker = marker
        self.times = times


_fault_lock = threading.Lock()
_fault_plans: List[_FaultPlan] = []


@contextlib.contextmanager
def inject_transients(marker: str = "preempted", times: int = 1):
    """Test hook: make the next ``times`` :func:`resilient_call` attempts
    fail with a synthetic transient error carrying ``marker``.

    The failure is raised *inside* the protected call path, so it exercises
    the real recovery machinery — ``retry_transients_total`` increments, the
    WARN ``transient_retry`` event lands on the caller's open span, and with
    ``times > _retries`` the exhaustion path surfaces the injected error.
    Process-global (any thread's resilient call consumes the plan), so
    pooled async solves are injectable from the submitting thread.
    """
    if marker not in _TRANSIENT_MARKERS:
        raise ValueError(f"marker {marker!r} is not one of the transient "
                         f"markers {_TRANSIENT_MARKERS}")
    plan = _FaultPlan(marker, int(times))
    with _fault_lock:
        _fault_plans.append(plan)
    try:
        yield plan
    finally:
        with _fault_lock:
            if plan in _fault_plans:
                _fault_plans.remove(plan)


def _maybe_inject() -> None:
    with _fault_lock:
        for plan in _fault_plans:
            if plan.times > 0:
                plan.times -= 1
                raise ValueError(
                    f"injected transient failure ({plan.marker})")


def resilient_call(fn: Callable, *args, _retries: int = 2, **kwargs) -> Any:
    """Call ``fn``; on a transient runtime failure, retry (at most
    ``_retries`` times)."""
    attempt = 0
    while True:
        try:
            _maybe_inject()
            return fn(*args, **kwargs)
        except ValueError as e:  # the reference's runtime errors' type
            marker = transient_marker(e)
            if attempt >= _retries or marker is None:
                raise
            attempt += 1
            _observe_retry(marker, attempt, _retries, e)
            log.warning("transient launch failure (%s); retrying (%d/%d)",
                        e, attempt, _retries)
            # the reference drops its compiled executables here; eager
            # torch keeps none, so only a callable with its own cache
            # clears it
            if hasattr(fn, "clear_cache"):
                fn.clear_cache()
