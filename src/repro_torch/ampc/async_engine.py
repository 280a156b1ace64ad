"""Async solve futures: ``engine.submit(graph, problem) -> AmpcFuture``.

The port of the JAX package's ``repro.ampc.async_engine``.  A bounded
worker pool behind the engine lets independent solves overlap their
host-side phases (validation, rank drawing, ternarization, output
assembly) while **device work stays serialized** through one engine-wide
launch lock (``AmpcEngine(serialize_launches=...)``): the AMPC accounting
model, where a launch is a materialized round, keeps exactly one program
in flight per engine.  The lock also keeps the module-global counters the
card run reads (``rounds.HOST_READS``, ``dht_gather.launches``) exact.

Surface (mixed into ``AmpcEngine``):

  * ``submit(graph, problem, ...) -> AmpcFuture`` — enqueue one solve.
    Bounded queue: when ``queue_depth`` solves are already waiting, submit
    **blocks** (backpressure) until a worker drains one.
  * ``submit_many(graphs, problem, ...) -> [AmpcFuture, ...]``.
  * ``shutdown(drain=True)`` — stop accepting work; drain or cancel the
    queue; join the workers.  Idempotent; also the engine's context-manager
    exit.

Every future is observable end to end: the worker wraps the solve in a
``solve[async]`` span (the pool-queue wait is recorded as a ``queue_wait``
event on it), transient launch failures retried by
:func:`repro_torch.runtime.retry.resilient_call` attach their WARN
``transient_retry`` events to that same span — the *owning* future's — and
the pool reports ``engine_async_submitted_total`` /
``engine_async_cancelled_total`` counters plus the ``engine_async_inflight``
gauge (back to 0 whenever the pool is idle).

A future resolves with the same :class:`AmpcResult` a sequential
``engine.solve`` call returns — equal outputs, its own per-solve
``RoundLedger`` with its one harvest — plus ``stats["async"]`` carrying
the queue wait and worker attribution.  Workers run on the engine's
device, never on the thread's current one.
"""
from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
from concurrent.futures import CancelledError, TimeoutError as FutureTimeout
from typing import Any, List, Optional, Sequence

import torch

from ..runtime.retry import resilient_call

__all__ = ["AmpcFuture", "AsyncEngineMixin", "CancelledError",
           "FutureTimeout"]

# future states
_PENDING = "PENDING"
_RUNNING = "RUNNING"
_DONE = "DONE"
_CANCELLED = "CANCELLED"

_STOP = object()          # worker sentinel
_ids = itertools.count(1)


class AmpcFuture:
    """Handle to one queued/running async solve.

    Mirrors the ``concurrent.futures.Future`` surface (``result`` /
    ``exception`` / ``cancel`` / ``done`` / ``cancelled`` / ``running``)
    with AMPC-specific metadata: the problem name, a process-unique
    ``future_id`` (the ``future`` attribute of its ``solve[async]`` span),
    and an optional deadline after which a still-queued solve fails with
    ``TimeoutError`` instead of starting.

    A running solve cannot be interrupted; ``cancel()`` succeeds only while
    the future is still queued.
    """

    def __init__(self, graph, problem: str, opts: dict,
                 deadline: Optional[float] = None, retries: int = 2):
        self.graph = graph
        self.problem = problem
        self.opts = opts
        self.deadline = deadline
        self.retries = retries
        self.future_id = next(_ids)
        self.span = None                      # solve[async] span when traced
        self._cond = threading.Condition()
        self._state = _PENDING
        self._result = None
        self._exc: Optional[BaseException] = None
        self._enqueued_at = time.monotonic()
        self._on_terminal = None              # engine callback, fired once

    # -- inspection --------------------------------------------------------
    def done(self) -> bool:
        with self._cond:
            return self._state in (_DONE, _CANCELLED)

    def cancelled(self) -> bool:
        with self._cond:
            return self._state == _CANCELLED

    def running(self) -> bool:
        with self._cond:
            return self._state == _RUNNING

    # -- consumer side -----------------------------------------------------
    def result(self, timeout: Optional[float] = None):
        """Block until resolved; return the ``AmpcResult``.

        Raises ``CancelledError`` if the future was cancelled, re-raises
        the solve's exception if it failed, and raises
        ``concurrent.futures.TimeoutError`` if ``timeout`` elapses first.
        """
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._state in (_DONE, _CANCELLED), timeout):
                raise FutureTimeout(
                    f"future {self.future_id} ({self.problem}) unresolved "
                    f"after {timeout}s")
            if self._state == _CANCELLED:
                raise CancelledError(
                    f"future {self.future_id} ({self.problem}) was cancelled")
            if self._exc is not None:
                raise self._exc
            return self._result

    def exception(self, timeout: Optional[float] = None):
        """The exception the solve raised (None on success); blocks like
        ``result``.  Raises ``CancelledError`` for cancelled futures."""
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._state in (_DONE, _CANCELLED), timeout):
                raise FutureTimeout(
                    f"future {self.future_id} ({self.problem}) unresolved "
                    f"after {timeout}s")
            if self._state == _CANCELLED:
                raise CancelledError(
                    f"future {self.future_id} ({self.problem}) was cancelled")
            return self._exc

    def cancel(self) -> bool:
        """Cancel if still queued.  Returns True on success; False once the
        solve is running or resolved (it cannot be interrupted)."""
        with self._cond:
            if self._state != _PENDING:
                return False
            self._state = _CANCELLED
            self._cond.notify_all()
        self._fire_terminal()
        return True

    # -- worker side -------------------------------------------------------
    def _try_start(self) -> bool:
        with self._cond:
            if self._state != _PENDING:
                return False
            self._state = _RUNNING
            return True

    def _finish(self, result=None, exc: Optional[BaseException] = None):
        with self._cond:
            self._result = result
            self._exc = exc
            self._state = _DONE
            self._cond.notify_all()
        self._fire_terminal()

    def _fire_terminal(self):
        cb, self._on_terminal = self._on_terminal, None
        if cb is not None:
            cb(self)

    def __repr__(self):
        with self._cond:
            return (f"AmpcFuture(id={self.future_id}, "
                    f"problem={self.problem!r}, state={self._state})")


class AsyncEngineMixin:
    """``submit``/``submit_many``/``shutdown`` for :class:`AmpcEngine`.

    The host class provides ``solve``, ``tracer``, ``metrics``, ``dht``,
    ``device``, and calls :meth:`_init_async` from ``__init__``.  The pool
    is lazy: a purely synchronous engine never spawns a thread.
    """

    # ------------------------------------------------------------------
    def _init_async(self, max_workers: int, queue_depth: Optional[int]):
        if max_workers < 1:
            raise ValueError(f"max_workers must be >= 1, got {max_workers}")
        self._async_workers = int(max_workers)
        self._async_depth = (2 * self._async_workers if queue_depth is None
                             else int(queue_depth))
        if self._async_depth < 1:
            raise ValueError(
                f"queue_depth must be >= 1, got {self._async_depth}")
        self._async_lock = threading.Lock()
        self._async_queue: Optional[queue.Queue] = None
        self._async_threads: List[threading.Thread] = []
        self._async_closed = False

    def _ensure_pool(self) -> queue.Queue:
        with self._async_lock:
            if self._async_closed:
                raise RuntimeError(
                    "engine is shut down; create a new AmpcEngine to submit")
            if self._async_queue is None:
                self._async_queue = queue.Queue(maxsize=self._async_depth)
                for i in range(self._async_workers):
                    t = threading.Thread(
                        target=self._worker_loop, name=f"ampc-worker-{i}",
                        daemon=True)
                    t.start()
                    self._async_threads.append(t)
            return self._async_queue

    # -- metrics helpers ---------------------------------------------------
    def _async_observe_submit(self, problem: str):
        m = self.metrics
        if m is None:
            return
        m.counter("engine_async_submitted_total",
                  labelnames=("problem",)).inc(1, problem=problem)
        m.gauge("engine_async_inflight").inc(1)

    def _async_on_terminal(self, fut: AmpcFuture):
        m = self.metrics
        if m is None:
            return
        if fut.cancelled():
            m.counter("engine_async_cancelled_total",
                      labelnames=("problem",)).inc(1, problem=fut.problem)
        m.gauge("engine_async_inflight").inc(-1)

    # ------------------------------------------------------------------
    def submit(self, graph, problem: str, *, seed: Optional[int] = None,
               epsilon: Optional[float] = None,
               timeout: Optional[float] = None,
               deadline: Optional[float] = None, retries: int = 2,
               snapshot=None, **opts) -> AmpcFuture:
        """Enqueue ``solve(graph, problem)`` on the worker pool.

        ``timeout`` (seconds from now) or ``deadline`` (absolute
        ``time.monotonic()`` value) bound the *queue* wait: a future whose
        deadline passes before a worker picks it up fails with
        ``TimeoutError`` instead of launching (a running solve is never
        interrupted mid-flight).  ``retries`` is the transient-failure
        retry budget forwarded to
        :func:`repro_torch.runtime.retry.resilient_call`.  ``snapshot`` is
        a :class:`~repro_torch.ampc.session.GraphSnapshot` (sessions pass
        it).

        Validation errors (unknown problem, missing weights, …) raise
        synchronously here, not on the future.  When the bounded queue is
        full, ``submit`` blocks — backpressure toward the producer.
        """
        from . import registry
        spec = registry.get(problem)          # raise unknown-problem now
        self._validate(spec, graph)
        if timeout is not None:
            deadline = time.monotonic() + float(timeout)
        call_opts = dict(opts)
        if seed is not None:
            call_opts["seed"] = seed
        if epsilon is not None:
            call_opts["epsilon"] = epsilon
        if snapshot is not None:
            call_opts["snapshot"] = snapshot
        q = self._ensure_pool()
        fut = AmpcFuture(graph, spec.name, call_opts, deadline=deadline,
                         retries=retries)
        fut._on_terminal = self._async_on_terminal
        self._async_observe_submit(spec.name)
        while True:
            # bounded-queue backpressure, but never wedge on a pool that
            # was shut down underneath a blocked producer.  The put happens
            # under the pool lock, after the closed check: a future put
            # once shutdown() has queued its stop sentinels would sit
            # behind them, and no worker would ever run it
            with self._async_lock:
                if self._async_closed:
                    fut.cancel()
                    raise RuntimeError(
                        "engine shut down while submit was blocked on a "
                        "full queue")
                try:
                    q.put(fut, timeout=0.05)
                    return fut
                except queue.Full:
                    pass

    def submit_many(self, graphs: Sequence[Any], problem: str,
                    **kwargs) -> List[AmpcFuture]:
        """``submit`` each graph; returns futures in input order.

        Backpressure applies per submit: with a bounded queue this call
        paces itself against the pool instead of buffering the whole fleet.
        """
        return [self.submit(g, problem, **kwargs) for g in graphs]

    # ------------------------------------------------------------------
    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the pool.  ``drain=True`` serves every queued future first;
        ``drain=False`` cancels queued futures (running solves still finish).
        Later ``submit`` calls raise ``RuntimeError``.  Idempotent."""
        with self._async_lock:
            already = self._async_closed
            self._async_closed = True
            q = self._async_queue
            threads = list(self._async_threads)
        if q is None or (already and not threads):
            return
        if not drain:
            # empty the queue; anything still pending is cancelled
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is not _STOP and isinstance(item, AmpcFuture):
                    item.cancel()
                q.task_done()
        for _ in threads:
            q.put(_STOP)
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in threads:
            t.join(timeout if deadline is None
                   else max(deadline - time.monotonic(), 0.0))
        with self._async_lock:
            self._async_threads = [t for t in self._async_threads
                                   if t.is_alive()]

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)
        return False

    # ------------------------------------------------------------------
    def _worker_loop(self):
        q = self._async_queue
        while True:
            item = q.get()
            try:
                if item is _STOP:
                    return
                self._run_future(item)
            finally:
                q.task_done()

    def _run_future(self, fut: AmpcFuture):
        wait_s = time.monotonic() - fut._enqueued_at
        if not fut._try_start():
            return                             # cancelled while queued
        if fut.deadline is not None and time.monotonic() > fut.deadline:
            fut._finish(exc=FutureTimeout(
                f"future {fut.future_id} ({fut.problem}) missed its "
                f"deadline after {wait_s:.3f}s in the pool queue"))
            return
        # the engine's device, not the worker thread's current one
        on_device = (torch.cuda.device(self.device)
                     if self.device.type == "cuda"
                     else contextlib.nullcontext())
        try:
            with on_device:
                res = self._traced_attempts(fut, wait_s)
        except BaseException as e:  # noqa: BLE001 - surfaced via .result()
            fut._finish(exc=e)
            return
        res.stats.setdefault("async", {
            "future": fut.future_id, "queue_wait_s": round(wait_s, 6),
            "worker": threading.current_thread().name})
        fut._finish(result=res)

    def _traced_attempts(self, fut: AmpcFuture, wait_s: float):
        tracer = self.tracer
        if not tracer.enabled:
            return self._solve_attempts(fut)
        # the owning future's span: the queue wait, every retry's WARN
        # event (runtime.retry attaches to the innermost open span of
        # *this* thread), and the attempts' solve spans all land here
        with tracer.span("solve[async]", problem=fut.problem,
                         backend=self.dht.name,
                         future=fut.future_id) as span:
            span.event("queue_wait", wait_s=round(wait_s, 6))
            fut.span = span
            res = self._solve_attempts(fut)
            res.trace = span
        return res

    def _solve_attempts(self, fut: AmpcFuture):
        """One-or-more solve attempts through the transient-retry path.

        Each attempt is a full ``solve`` with a **fresh** ledger, so a
        retried solve never double-counts rounds or queries; the result's
        ledger always describes exactly the attempt that succeeded.
        """
        return resilient_call(self.solve, fut.graph, fut.problem,
                              _retries=fut.retries, **fut.opts)
