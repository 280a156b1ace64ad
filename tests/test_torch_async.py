"""The port's async serving (``submit``, ``submit_many``, ``shutdown``) and
its transient-failure retry, mirroring ``tests/test_async_engine.py`` and
the retry cases of ``tests/test_obs.py``.

Futures resolve with results equal to the port's sequential ``solve`` and
to the JAX package's ``solve`` (outputs, ledgers without times); bounded
queues apply backpressure; queued futures cancel and miss deadlines; an
injected transient is retried on the owning future's span; a storm of
submits, cancellations and a mid-stream ``shutdown`` neither deadlocks nor
drops a result, and ``engine_async_inflight`` returns to 0.
"""
import sys
import threading
import time

import numpy as np
import pytest

from repro.ampc import AmpcEngine as JaxEngine
from repro.graph import generators as jgen

from repro_torch.ampc import AmpcEngine, SNAPSHOT_PROBLEMS, get_problem
from repro_torch.ampc.async_engine import CancelledError, FutureTimeout
from repro_torch.convert import graph_from_reference
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.trace import Tracer
from repro_torch.runtime import retry
from repro_torch.runtime.retry import (inject_transients, is_transient,
                                       resilient_call, transient_marker)

# every problem with a batch adapter but msf: the reference test's set
BATCH_SAFE = ["mis", "matching", "weighted-matching", "vertex-cover",
              "connectivity", "one-vs-two"]
LEDGER_KEYS = ("algorithm", "shuffles", "bytes_shuffled", "dht_queries",
               "dht_bytes", "dht_query_waves", "dedup_savings",
               "dht_overflows")


def _jax_input(name):
    if get_problem(name).needs_cycles:
        return jgen.two_cycles(40)
    g = jgen.erdos_renyi(80, 3.0, seed=2)
    return g.with_random_weights(3) if get_problem(name).needs_weights else g


def _input_for(name):
    return graph_from_reference(_jax_input(name))


def _assert_same_output(a, b):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_submit_equals_solve_and_jax_solve():
    """All batch-safe problems in flight at once equal their sequential
    runs, and the JAX engine's."""
    jeng = JaxEngine(seed=0, metrics=False)
    with AmpcEngine(seed=0, max_workers=4, device="cpu") as eng:
        futures = {name: eng.submit(_input_for(name), name)
                   for name in BATCH_SAFE}
        for name, fut in futures.items():
            res = fut.result(timeout=300)
            seq = eng.solve(_input_for(name), name)
            want = jeng.solve(_jax_input(name), name)
            _assert_same_output(res.output, seq.output)
            _assert_same_output(res.output, want.output)
            for k in LEDGER_KEYS:
                assert res.ledger[k] == seq.ledger[k] == want.ledger[k], \
                    (name, k)
            assert res.stats["async"]["future"] == fut.future_id


def test_out_of_order_results_keep_their_ledgers():
    with AmpcEngine(seed=0, max_workers=3, device="cpu") as eng:
        futs = [eng.submit(_input_for(name), name) for name in BATCH_SAFE]
        seq = {name: eng.solve(_input_for(name), name)
               for name in BATCH_SAFE}
        for name, fut in reversed(list(zip(BATCH_SAFE, futs))):
            res = fut.result(timeout=300)
            for k in LEDGER_KEYS:
                assert res.ledger[k] == seq[name].ledger[k], (name, k)


def test_submit_many_parity_and_backpressure():
    graphs = [graph_from_reference(jgen.erdos_renyi(60, 3.0, seed=s))
              for s in range(6)]
    with AmpcEngine(seed=0, max_workers=1, queue_depth=1,
                    device="cpu") as eng:
        futs = eng.submit_many(graphs, "mis")
        for fut, g in zip(futs, graphs):
            np.testing.assert_array_equal(fut.result(timeout=300).output,
                                          eng.solve(g, "mis").output)


def test_deadline_missed_in_queue_times_out():
    with AmpcEngine(seed=0, max_workers=1, device="cpu") as eng:
        fut = eng.submit(_input_for("mis"), "mis", timeout=-1.0)
        with pytest.raises(FutureTimeout):
            fut.result(timeout=60)


def test_cancel_semantics():
    g = _input_for("mis")
    with AmpcEngine(seed=0, max_workers=1, device="cpu") as eng:
        blocker = eng.submit(g, "mis")
        target = eng.submit(g, "mis")
        won = target.cancel()
        assert target.cancel() is False or won
        if won:
            assert target.cancelled() and target.done()
            with pytest.raises(CancelledError):
                target.result(timeout=60)
        else:
            np.testing.assert_array_equal(target.result(timeout=300).output,
                                          eng.solve(g, "mis").output)
        blocker.result(timeout=300)


def test_submit_validates_synchronously():
    with AmpcEngine(seed=0, device="cpu") as eng:
        with pytest.raises(KeyError, match="unknown problem"):
            eng.submit(_input_for("mis"), "no-such-problem")
        with pytest.raises(ValueError, match="needs edge weights"):
            eng.submit(_input_for("mis"), "weighted-matching")
    with pytest.raises(ValueError, match="max_workers"):
        AmpcEngine(max_workers=0, device="cpu")


# =========================================================================
# transient retry
# =========================================================================
def test_injected_transient_retries_once_and_succeeds():
    g = _input_for("matching")
    ctr = default_registry().counter("retry_transients_total",
                                     labelnames=("marker",))
    before = ctr.value(marker="preempted")
    with AmpcEngine(seed=0, device="cpu") as eng:
        want = eng.solve(g, "matching")
        with inject_transients(marker="preempted", times=1):
            res = eng.submit(g, "matching").result(timeout=300)
    assert ctr.value(marker="preempted") == before + 1
    np.testing.assert_array_equal(res.output, want.output)
    for k in LEDGER_KEYS:
        assert res.ledger[k] == want.ledger[k]


def test_retry_warn_event_on_owning_span():
    tracer = Tracer()
    g = _input_for("mis")
    with AmpcEngine(seed=0, trace=tracer, metrics=MetricsRegistry(),
                    device="cpu") as eng:
        with inject_transients(marker="RESOURCE_EXHAUSTED", times=1):
            fut = eng.submit(g, "mis")
            res = fut.result(timeout=300)
    span = res.trace
    assert span.name == "solve[async]"
    assert span.attributes["future"] == fut.future_id
    warns = [e for e in span.events if e.name == "transient_retry"]
    assert len(warns) == 1 and warns[0].level == "WARN"
    assert warns[0].attributes["marker"] == "RESOURCE_EXHAUSTED"
    assert [e for e in span.events if e.name == "queue_wait"]


def test_exhausted_retries_surface_original_error_without_wedging():
    g = _input_for("mis")
    with AmpcEngine(seed=0, device="cpu") as eng:
        want = eng.solve(g, "mis")
        with inject_transients(marker="preempted", times=10):
            fut = eng.submit(g, "mis", retries=2)
            with pytest.raises(ValueError, match="injected transient"):
                fut.result(timeout=300)
        assert fut.done() and not fut.cancelled()
        res = eng.submit(g, "mis").result(timeout=300)
        np.testing.assert_array_equal(res.output, want.output)


def test_resilient_call_retries_only_transient_value_errors():
    calls = []

    def flaky(kind):
        calls.append(kind)
        if len(calls) == 1:
            raise kind("RESOURCE_EXHAUSTED: out of buffers")
        return 42

    tr = Tracer()
    with tr.span("solve"):
        assert resilient_call(flaky, ValueError) == 42
    [ev] = [e for e in tr.spans()[0].events if e.name == "transient_retry"]
    assert (ev.level, ev.attributes["attempt"]) == ("WARN", 1)
    # no net for other errors (a CUDA error is a RuntimeError), and none
    # for a ValueError without a transient marker
    calls.clear()
    with pytest.raises(RuntimeError):
        resilient_call(flaky, RuntimeError)
    assert len(calls) == 1

    def bad():
        calls.append(None)
        raise ValueError("shape mismatch")

    calls.clear()
    with pytest.raises(ValueError, match="shape mismatch"):
        resilient_call(bad)
    assert len(calls) == 1
    assert transient_marker(ValueError("... preempted ...")) == "preempted"
    assert is_transient(ValueError("RESOURCE_EXHAUSTED"))
    assert not is_transient(ValueError("other"))
    with pytest.raises(ValueError, match="transient markers"):
        with inject_transients(marker="out of memory"):
            pass


def test_resilient_call_clears_a_callables_own_cache():
    class Cached:
        cleared = 0

        def clear_cache(self):
            self.cleared += 1

        def __call__(self):
            return "ok"

    fn = Cached()
    with inject_transients(marker="preempted", times=2):
        assert resilient_call(fn) == "ok"
    assert fn.cleared == 2
    assert not retry._fault_plans


# =========================================================================
# stress and shutdown
# =========================================================================
def test_stress_no_deadlock_no_drops_inflight_returns_to_zero():
    n_threads, m_submits = 4, 6
    reg = MetricsRegistry()
    graphs = {s: graph_from_reference(jgen.erdos_renyi(48, 3.0, seed=s))
              for s in range(4)}
    eng = AmpcEngine(seed=0, metrics=reg, max_workers=3, queue_depth=2,
                     device="cpu")
    expected = {s: eng.solve(g, "mis").output for s, g in graphs.items()}
    collected, refused = [], []
    lock = threading.Lock()

    def producer(tid):
        rng = np.random.default_rng(tid)
        for i in range(m_submits):
            s = int(rng.integers(len(graphs)))
            try:
                fut = eng.submit(graphs[s], "mis")
            except RuntimeError:
                with lock:
                    refused.append((tid, i))
                continue
            if rng.random() < 0.3:
                fut.cancel()
            with lock:
                collected.append((s, fut))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(n_threads)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        time.sleep(0.05)
        eng.shutdown(drain=True, timeout=300)
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "producer wedged on a shut-down engine"
    finally:
        sys.setswitchinterval(switch)

    seen = set()
    for s, fut in collected:
        assert id(fut) not in seen, "duplicated future"
        seen.add(id(fut))
        try:
            res = fut.result(timeout=300)
        except CancelledError:
            assert fut.cancelled()
            continue
        np.testing.assert_array_equal(res.output, expected[s])
    assert time.monotonic() - t0 < 600
    assert reg.gauge("engine_async_inflight").value() == 0
    submitted = reg.counter("engine_async_submitted_total",
                            labelnames=("problem",)).value(problem="mis")
    assert len(collected) <= submitted <= len(collected) + len(refused)
    assert len(collected) + len(refused) == n_threads * m_submits


def test_shutdown_drain_false_cancels_queued():
    g = _input_for("mis")
    reg = MetricsRegistry()
    with AmpcEngine(seed=0, metrics=reg, max_workers=1, queue_depth=8,
                    device="cpu") as eng:
        futs = [eng.submit(g, "mis") for _ in range(5)]
        eng.shutdown(drain=False, timeout=300)
        outcomes = {"done": 0, "cancelled": 0}
        for fut in futs:
            try:
                fut.result(timeout=300)
                outcomes["done"] += 1
            except CancelledError:
                outcomes["cancelled"] += 1
        assert outcomes["done"] + outcomes["cancelled"] == 5
        assert reg.gauge("engine_async_inflight").value() == 0
        cancelled = reg.counter("engine_async_cancelled_total",
                                labelnames=("problem",)).value(problem="mis")
        assert cancelled == outcomes["cancelled"]
    with pytest.raises(RuntimeError):
        eng.submit(g, "mis")
    eng.shutdown()  # idempotent


# =========================================================================
# sessions through the pool
# =========================================================================
def test_session_submit_shares_the_snapshot():
    g = graph_from_reference(jgen.erdos_renyi(60, 3.0, seed=4))
    with AmpcEngine(seed=0, device="cpu") as eng:
        sess = eng.session(g)
        sess.solve("mis")
        res = sess.submit("matching").result(timeout=300)
        assert res.stats["snapshot"]["hit"] is True
        assert res.ledger["shuffles"] == 1
        np.testing.assert_array_equal(res.output,
                                      eng.solve(g, "matching").output)
        res = sess.submit("matching-levels").result(timeout=300)
        assert "snapshot" not in res.stats   # passed through unchanged


def test_session_trace_shows_the_skipped_shuffle():
    g = graph_from_reference(jgen.erdos_renyi(80, 3.0, seed=2))
    tracer = Tracer()
    with AmpcEngine(seed=0, trace=tracer, device="cpu") as eng:
        sess = eng.session(g)
        cold = sess.solve("mis")
        warm = sess.solve("matching")
    assert [c.name for c in cold.trace.children
            if c.name.startswith("shuffle:")][0] == "shuffle:WriteGraphKV"
    assert [c.name for c in warm.trace.children
            if c.name.startswith("shuffle:")] == ["shuffle:IsInMM"]
    assert "msf" in SNAPSHOT_PROBLEMS
