"""The port's two accounting modes, as ``tests/test_dht_deferred.py`` holds
the reference's (tolerance 0: both are exact integer bookkeeping).

  1. A bare ``RoundLedger()`` is eager (``deferred=False``), as in the
     reference: its counters can be read right after a lookup, with no
     harvest, and equal the JAX bare ledger's.
  2. Eager and deferred ledgers give bit-identical outputs and counters, on
     the local gather and on the router, and so does the engine's
     ``deferred_accounting=False`` against the JAX eager engine.
  3. ``harvest`` returns ``extra`` in both modes; zero-length key batches
     record zeros in both.
  4. A warm deferred solve harvests once, on the router too, through
     ``solve``, a session and a ``solve_many`` bucket, and a deferred
     routed lookup makes no host read and no transfer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.ampc import AmpcEngine as JaxEngine
from repro.core import dht as jdht
from repro.core.rounds import RoundLedger as JaxLedger
from repro.graph import generators as jgen

from repro_torch.ampc import AmpcEngine
from repro_torch.convert import graph_from_arrays, graph_from_reference
from repro_torch.core import dht, rounds
from repro_torch.core.rounds import RoundLedger, harvest_many

COUNTERS = ("shuffles", "bytes_shuffled", "dht_queries", "dht_bytes",
            "dht_query_waves", "dedup_savings", "dht_overflows")
MESHES = {"local": None, "routed1": dht.make_mesh(1),
          "routed3": dht.make_mesh(3)}


def counters(ledger):
    summ = ledger if isinstance(ledger, dict) else ledger.summary()
    return {k: summ[k] for k in COUNTERS}


def _random_graph(draw):
    n = draw(st.integers(6, 40))
    m = draw(st.integers(0, 80))
    rng = np.random.default_rng(draw(st.integers(0, 10_000)))
    return graph_from_arrays(
        n, rng.integers(0, n, (m, 2)).astype(np.int32)).dedup()


# ---------------------------------------------------------------- the fault
def test_bare_ledger_counts_at_once_like_the_reference():
    """The fault this mode repairs: a bare ledger's counters were 0 until a
    harvest.  Now they are readable right after the lookup, equal to the
    JAX bare ledger's, and nothing is left to harvest."""
    keys = np.array([1, 1, 2, -1], np.int32)
    jled = JaxLedger("bare")
    jdht.ShardedDHT(jnp.arange(8, dtype=jnp.int32),
                    ledger=jled).lookup(keys)
    for mesh in MESHES.values():
        led = RoundLedger("bare")
        assert led.deferred is False
        dht.ShardedDHT(torch.arange(8, dtype=torch.int32), ledger=led,
                       mesh=mesh).lookup(torch.from_numpy(keys))
        assert led.dht_queries == 2 and led.dedup_savings == 1
        assert counters(led) == counters(jled)
        assert len(led.device) == 0 and led.harvest() is None


def test_engine_ledgers_are_deferred_unless_asked():
    g = graph_from_arrays(4, np.array([[0, 1], [2, 3]]))
    deferred = AmpcEngine(device="cpu").solve(g, "mis").raw_ledger
    eager = AmpcEngine(device="cpu",
                       deferred_accounting=False).solve(g, "mis").raw_ledger
    assert deferred.deferred is True and eager.deferred is False


# ----------------------------------------------------------- DHT level
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@settings(max_examples=8, deadline=None)
@given(data=st.data())
def test_eager_and_deferred_counters_bit_identical(mesh, data):
    nvals = data.draw(st.integers(1, 50))
    keys = torch.tensor(
        data.draw(st.lists(st.integers(-1, nvals - 1), min_size=1,
                           max_size=100)), dtype=torch.int32)
    wide = data.draw(st.booleans())
    values = (torch.arange(nvals * 3, dtype=torch.int32).reshape(nvals, 3)
              if wide else torch.arange(nvals, dtype=torch.int32) * 3)
    dedup = data.draw(st.booleans())
    capacity = data.draw(st.sampled_from([None, 1, 2]))
    eager, deferred = RoundLedger("e"), RoundLedger("d", deferred=True)
    outs = [dht.ShardedDHT(values, ledger=led, mesh=MESHES[mesh],
                           capacity=capacity).lookup(keys, dedup=dedup)
            for led in (eager, deferred)]
    assert deferred.dht_queries == 0 and len(deferred.device) == 1
    deferred.harvest()
    assert torch.equal(outs[0], outs[1])
    assert counters(eager) == counters(deferred)


def test_eager_local_lookup_reads_twice_deferred_never():
    """The reference's eager take path syncs twice a lookup (the valid
    count before the gather, the distinct count after); a deferred lookup
    on either backend copies nothing until its harvest, which copies once."""
    values, keys = torch.arange(10) * 2, torch.tensor([3, 3, 5, -1, 9])
    for mesh, eager_copies in ((None, 2), (dht.make_mesh(2), 1)):
        t0 = rounds.TRANSFERS
        dht.ShardedDHT(values, ledger=RoundLedger("e"),
                       mesh=mesh).lookup(keys)
        assert rounds.TRANSFERS - t0 == eager_copies
        led = RoundLedger("d", deferred=True)
        t0 = rounds.TRANSFERS
        out = dht.ShardedDHT(values, ledger=led, mesh=mesh).lookup(keys)
        assert rounds.TRANSFERS == t0
        led.harvest(out)
        assert rounds.TRANSFERS - t0 == 1


def test_deferred_routed_lookup_makes_no_host_read():
    values = torch.arange(40, dtype=torch.int32).reshape(20, 2)
    keys = torch.tensor([0, 19, 7, 7, -1, 3, 12], dtype=torch.int32)
    for capacity in (None, 1):
        led = RoundLedger("d", deferred=True)
        reads, copies = rounds.HOST_READS, rounds.TRANSFERS
        dht.ShardedDHT(values, ledger=led, mesh=dht.make_mesh(4),
                       capacity=capacity).lookup(keys)
        assert (rounds.HOST_READS, rounds.TRANSFERS) == (reads, copies)
        assert len(led.device) == 1 and led.dht_queries == 0


@pytest.mark.parametrize("deferred", [False, True],
                         ids=["eager", "deferred"])
def test_harvest_returns_extra(deferred):
    led = RoundLedger("x", deferred=deferred)
    dht.ShardedDHT(torch.arange(8, dtype=torch.int32),
                   ledger=led).lookup(torch.tensor([3, 3, 5]))
    calls = []
    rounds.HARVEST_HOOK = calls.append
    t0 = rounds.TRANSFERS
    try:
        out, total, host = led.harvest((torch.tensor(11, dtype=torch.int32),
                                        torch.arange(3), 7))
        single = led.harvest(torch.tensor([True, False]))
    finally:
        rounds.HARVEST_HOOK = None
    assert calls == [led, led]
    # eager: one copy a tensor leaf; deferred: one copy a harvest
    assert rounds.TRANSFERS - t0 == (2 if deferred else 3)
    assert int(out) == 11 and host == 7
    np.testing.assert_array_equal(total, [0, 1, 2])
    np.testing.assert_array_equal(single, [True, False])
    assert isinstance(single, np.ndarray)
    assert led.dht_queries == 2 and led.dedup_savings == 1


@pytest.mark.parametrize("deferred", [False, True],
                         ids=["eager", "deferred"])
def test_harvest_many_returns_extra(deferred):
    leds = [RoundLedger(str(i), deferred=deferred) for i in range(2)]
    for led in leds:
        dht.ShardedDHT(torch.arange(6), ledger=led,
                       mesh=dht.make_mesh(2)).lookup(torch.tensor([1, 4, 4]))
    calls = []
    rounds.HARVEST_HOOK = calls.append
    try:
        got = harvest_many(leds, ([torch.arange(2), None], torch.tensor(5)))
    finally:
        rounds.HARVEST_HOOK = None
    assert len(calls) == 1
    np.testing.assert_array_equal(got[0][0], [0, 1])
    assert got[0][1] is None and int(got[1]) == 5
    assert [led.dht_queries for led in leds] == [3, 3]


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("impl", ["take", "cuda"])
def test_zero_length_query_batch(impl, mesh):
    for deferred in (False, True):
        led = RoundLedger("z", deferred=deferred)
        out = dht.ShardedDHT(torch.arange(6, dtype=torch.int32) * 2,
                             ledger=led, impl=impl, mesh=MESHES[mesh]).lookup(
                                 torch.zeros(0, dtype=torch.int32))
        led.harvest()
        assert out.shape == (0,)
        assert led.dht_queries == 0 and led.dht_bytes == 0
    wide = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    out = dht.ShardedDHT(wide, impl=impl, mesh=MESHES[mesh]).lookup(
        torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 2)


# ---------------------------------------------------------- engine level
@pytest.mark.parametrize("problem", ["mis", "matching", "connectivity"])
def test_eager_engine_matches_jax_eager_engine(problem):
    jg = jgen.erdos_renyi(56, 3.0, seed=2)
    g = graph_from_reference(jg)
    want = JaxEngine(seed=0, deferred_accounting=False,
                     metrics=False).solve(jg, problem)
    eager = AmpcEngine(seed=0, deferred_accounting=False, device="cpu",
                       metrics=False).solve(g, problem)
    deferred = AmpcEngine(seed=0, device="cpu",
                          metrics=False).solve(g, problem)
    for got in (eager, deferred):
        np.testing.assert_array_equal(got.output, want.output)
        assert counters(got.ledger) == counters(want.ledger)
        assert list(got.ledger["phase_times"]) == \
            list(want.ledger["phase_times"])


@settings(max_examples=4, deadline=None)
@given(st.data())
def test_engine_deferred_matches_eager(data):
    g = _random_graph(data.draw)
    problem = data.draw(st.sampled_from(["mis", "matching", "connectivity"]))
    seed = data.draw(st.integers(0, 1000))
    backend = data.draw(st.sampled_from(["local", "routed"]))
    res_d = AmpcEngine(seed=seed, dht_backend=backend,
                       device="cpu").solve(g, problem)
    res_e = AmpcEngine(seed=seed, dht_backend=backend, device="cpu",
                       deferred_accounting=False).solve(g, problem)
    np.testing.assert_array_equal(res_d.output, res_e.output)
    assert counters(res_d.ledger) == counters(res_e.ledger)


def test_engine_routed_deferred_matches_local():
    g = graph_from_reference(jgen.erdos_renyi(48, 3.0, seed=5))
    for problem in ("mis", "connectivity"):
        r = AmpcEngine(seed=0, dht_backend="routed",
                       device="cpu").solve(g, problem)
        e = AmpcEngine(seed=0, dht_backend="routed", device="cpu",
                       deferred_accounting=False).solve(g, problem)
        loc = AmpcEngine(seed=0, device="cpu").solve(g, problem)
        assert counters(r.ledger) == counters(e.ledger) == \
            counters(loc.ledger)
        np.testing.assert_array_equal(r.output, loc.output)


@pytest.fixture
def harvest_log():
    calls = []
    rounds.HARVEST_HOOK = calls.append
    try:
        yield calls
    finally:
        rounds.HARVEST_HOOK = None


def _graph_for(problem):
    if problem == "one-vs-two":
        return graph_from_reference(jgen.two_cycles(24))
    g = jgen.erdos_renyi(56, 3.0, seed=2)
    return graph_from_reference(
        g.with_random_weights(seed=3) if problem == "msf" else g)


@pytest.mark.parametrize("backend", ["routed", dht.make_mesh(4)],
                         ids=["routed1", "routed4"])
def test_warm_routed_solve_single_harvest(harvest_log, backend):
    mesh = backend if isinstance(backend, dht.DhtMesh) else None
    eng = AmpcEngine(mesh=mesh, dht_backend="routed", seed=0, device="cpu")
    local = AmpcEngine(seed=0, device="cpu")

    def host_reads(engine, problem):
        before = rounds.HOST_READS
        engine.solve(_graph_for(problem), problem)
        return rounds.HOST_READS - before

    for problem in ("mis", "matching", "connectivity", "one-vs-two", "msf"):
        eng.solve(_graph_for(problem), problem)
        harvest_log.clear()
        reads = host_reads(eng, problem)
        assert len(harvest_log) == 1, (problem, len(harvest_log))
        # the fixpoints read their loop condition once a wave; the routed
        # reads add none
        assert reads == host_reads(local, problem), problem


def test_warm_routed_session_single_harvest(harvest_log):
    g = graph_from_reference(
        jgen.erdos_renyi(48, 2.0, seed=7).with_random_weights(seed=1))
    sess = AmpcEngine(dht_backend="routed", seed=0,
                      device="cpu").session(g)
    sess.solve("mis")
    harvest_log.clear()
    assert sess.solve("matching").stats["snapshot"]["hit"] is True
    assert len(harvest_log) == 1
    for problem in ("msf", "connectivity"):
        sess.solve(problem)
        harvest_log.clear()
        res = sess.solve(problem)
        assert res.stats["snapshot"]["hit"] is True and res.shuffles == 1
        assert len(harvest_log) == 1, (problem, len(harvest_log))


def test_warm_routed_solve_many_single_harvest_per_bucket(harvest_log):
    from repro_torch.graph.batching import bucketize
    fleet = [graph_from_reference(jgen.erdos_renyi(40, 3.0, seed=s))
             for s in range(4)]
    wfleet = [graph_from_reference(jgen.erdos_renyi(
        40, 2.0 if s % 2 else 10.0, seed=s).with_random_weights(seed=s))
        for s in range(4)]
    eng = AmpcEngine(dht_backend="routed", seed=0, device="cpu")
    for graphs, problem in ((fleet, "mis"), (fleet, "connectivity"),
                            (wfleet, "msf")):
        eng.solve_many(graphs, problem)
        harvest_log.clear()
        results = eng.solve_many(graphs, problem)
        assert len(results) == 4
        assert len(harvest_log) == len(bucketize(graphs)), problem
