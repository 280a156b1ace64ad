"""The port's ``AmpcEngine.solve_many`` against the JAX package's
(tolerance 0).

For each of the seven batch adapters, on ``tests/test_solve_many.py``'s
fleets (16 mixed-size graphs, the weighted riders, the mixed dense/sparse
msf fleet, the cycle fleet): a cold and a warm ``solve_many`` of each
package give equal outputs, stats (``solver_cache`` and ``batch``
included) and ledger summaries (times left out), equal ``cache_info()``
after each call, and one ``rounds.HARVEST_HOOK`` call per bucket.  The
batching helpers (``bucketize``, ``pad_graphs``, ``ternarize_batch``) are
array-equal to the reference's.  Graphs are built by the JAX package's
generators and carried across with ``repro_torch.convert``.
"""
import numpy as np
import pytest
import torch

from repro.ampc import AmpcEngine as JaxEngine
from repro.ampc import LocalDht as JaxLocalDht
from repro.core.rounds import RoundLedger as JaxLedger
from repro.core.ternarize import ternarize_batch as jax_ternarize_batch
from repro.graph import batching as jbatching
from repro.graph import generators as jgen
from repro.obs.trace import Tracer as JaxTracer

from repro_torch.ampc import AmpcEngine, LocalDht, registry
from repro_torch.ampc.engine import _field_eq
from repro_torch.convert import graph_from_reference
from repro_torch.core import rounds
from repro_torch.core.ternarize import ternarize_batch
from repro_torch.graph import batching
from repro_torch.obs.trace import Tracer

FLEET_SIZES = [50, 60, 100, 120, 70, 50, 90, 110, 55, 65, 95, 115, 75, 85,
               105, 125]


def _fleet():
    return [jgen.erdos_renyi(n, 3.0, seed=i)
            for i, n in enumerate(FLEET_SIZES)]


def _riders():
    return [g.with_random_weights(i) for i, g in enumerate(_fleet()[:6])]


def _weighted_fleet():
    # even graphs sparse (truncated-Prim pipeline), odd ones dense (the
    # Borůvka shortcut), as tests/test_solve_many.py builds them
    return [jgen.erdos_renyi(24 + 5 * i, 2.0 if i % 2 == 0 else 12.0,
                             seed=i).with_random_weights(seed=100 + i)
            for i in range(16)]


def _cycle_fleet():
    ks = [30, 40, 60, 30, 45, 50, 35, 55, 40, 30, 60, 45, 50, 35, 55, 30]
    return [jgen.two_cycles(k) if i % 2 == 0 else jgen.one_cycle(2 * k)
            for i, k in enumerate(ks)]


FLEETS = {"fleet": _fleet, "riders": _riders, "weighted": _weighted_fleet,
          "cycles": _cycle_fleet}
CASES = [("mis", "fleet", {}), ("matching", "fleet", {}),
         ("vertex-cover", "fleet", {}), ("connectivity", "fleet", {}),
         ("weighted-matching", "riders", {}), ("vertex-cover", "riders", {}),
         ("msf", "weighted", {}), ("one-vs-two", "cycles", {"p": 1 / 8})]


def _ledger_equal(a, b):
    a, b = dict(a), dict(b)
    for led in (a, b):
        led.pop("wall_time_s")
    pa, pb = a.pop("phase_times"), b.pop("phase_times")
    return a == b and list(pa) == list(pb)


def _cache(info):
    return (info.hits, info.misses, info.size)


@pytest.mark.parametrize("problem,fleet,opts", CASES,
                         ids=[f"{p}-{f}" for p, f, _ in CASES])
def test_solve_many_matches_jax_solve_many(problem, fleet, opts):
    jfleet = FLEETS[fleet]()
    tfleet = [graph_from_reference(g) for g in jfleet]
    jeng = JaxEngine(seed=0, metrics=False)
    eng = AmpcEngine(seed=0, device="cpu", metrics=False)
    n_buckets = len(batching.bucketize(tfleet))
    for call in ("cold", "warm"):
        want = jeng.solve_many(jfleet, problem, **opts)
        calls = []
        rounds.HARVEST_HOOK = calls.append
        try:
            got = eng.solve_many(tfleet, problem, **opts)
        finally:
            rounds.HARVEST_HOOK = None
        assert len(calls) == n_buckets, call
        assert len(got) == len(want) == len(tfleet)
        for i, (g, w) in enumerate(zip(got, want)):
            assert (g.problem, g.model, g.backend) == \
                (w.problem, w.model, w.backend)
            np.testing.assert_array_equal(g.output, w.output)
            assert np.asarray(g.output).dtype == np.asarray(w.output).dtype
            assert _field_eq(g.stats, w.stats), (call, i, g.stats, w.stats)
            assert _ledger_equal(g.ledger, w.ledger), (call, i, g.ledger,
                                                       w.ledger)
        assert _cache(eng.cache_info()) == _cache(jeng.cache_info()), call
    info = eng.cache_info()
    # cold: one miss a bucket (msf: one a sub-launch); warm: all hits
    assert info.hits >= len(tfleet)
    # every output equals the port's own sequential solve
    for g, r in zip(tfleet, got):
        want = eng.solve(g, problem, **opts).output
        np.testing.assert_array_equal(r.output, want)


def test_msf_fleet_takes_both_paths():
    tfleet = [graph_from_reference(g) for g in _weighted_fleet()]
    res = AmpcEngine(seed=0, device="cpu").solve_many(tfleet, "msf")
    assert {r.stats["path"] for r in res} == {"sparse", "dense"}


def test_batch_adapters_equal_the_reference_registry():
    from repro.ampc import registry as jregistry
    for name in registry.names():
        assert (registry.get(name).batch_fn is None) == \
            (jregistry.get(name).batch_fn is None), name


def test_sequential_fallback_and_validation():
    eng = AmpcEngine(seed=0, device="cpu")
    fleet = [graph_from_reference(g) for g in _fleet()[:2]]
    assert registry.get("matching-levels").batch_fn is None
    for g, res in zip(fleet, eng.solve_many(fleet, "matching-levels")):
        np.testing.assert_array_equal(
            res.output, eng.solve(g, "matching-levels").output)
    assert eng.cache_info().misses == 0
    with pytest.raises(ValueError, match="needs edge weights"):
        eng.solve_many(fleet, "weighted-matching")
    with pytest.raises(ValueError, match="union of cycles"):
        eng.solve_many(fleet, "one-vs-two")


def test_clear_cache_resets_both_caches():
    eng = AmpcEngine(seed=0, device="cpu")
    fleet = [graph_from_reference(g) for g in _fleet()[:4]]
    eng.solve_many(fleet, "mis")
    eng.session(fleet[0]).solve("mis")
    assert eng.cache_info().size > 0 and eng.cache_info("snapshot").size == 1
    eng.clear_cache()
    for kind in ("solver", "snapshot"):
        assert _cache(eng.cache_info(kind)) == (0, 0, 0)


def test_solve_many_trace_matches_jax():
    jfleet = _fleet()[:4]
    tfleet = [graph_from_reference(g) for g in jfleet]
    jtr, ttr = JaxTracer(), Tracer()
    JaxEngine(seed=0, trace=jtr, metrics=False).solve_many(jfleet, "mis")
    AmpcEngine(seed=0, trace=ttr, metrics=False,
               device="cpu").solve_many(tfleet, "mis")

    def names(tracer):
        return [s.name for root in tracer.spans() for s in root.walk()]

    assert names(ttr) == names(jtr)
    assert "bucket" in names(ttr) and "graph[0]" in names(ttr)


# --------------------------------------------------------------------------
# the batching helpers, array-equal to the reference's
# --------------------------------------------------------------------------
def _assert_batches_equal(got, want):
    assert (got.n_bucket, got.m_bucket, got.indices) == \
        (want.n_bucket, want.m_bucket, want.indices)
    for field in ("n", "m", "edges", "edge_mask", "node_mask", "weights"):
        a, b = getattr(got, field), getattr(want, field)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype, field
    for a, b in zip(got.padded_symmetric(), want.padded_symmetric()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fleet", ["fleet", "riders", "weighted"])
def test_bucketize_and_pad_graphs_match_jax(fleet):
    jfleet = FLEETS[fleet]()
    tfleet = [graph_from_reference(g) for g in jfleet]
    got, want = batching.bucketize(tfleet), jbatching.bucketize(jfleet)
    assert list(got) == list(want)
    for key in want:
        _assert_batches_equal(got[key], want[key])
    assert [batching.next_pow2(x) for x in (0, 1, 3, 129)] == \
        [jbatching.next_pow2(x) for x in (0, 1, 3, 129)]
    assert batching.bucket_shape(100, 150) == jbatching.bucket_shape(100, 150)


def test_pad_graphs_rejects_oversized():
    g = graph_from_reference(jgen.erdos_renyi(100, 3.0, seed=0))
    with pytest.raises(ValueError, match="exceeds bucket"):
        batching.pad_graphs([g], [0], 64, 64)


def test_ternarize_batch_matches_jax():
    jfleet = _weighted_fleet()[::2]
    got = ternarize_batch([graph_from_reference(g) for g in jfleet])
    want = jax_ternarize_batch(jfleet)
    assert (got.nt_bucket, got.mt_bucket) == (want.nt_bucket, want.mt_bucket)
    for field in ("n_tern", "m_tern", "nbr", "nbw", "nbe", "edges",
                  "weights", "orig_eid", "edge_mask", "node_mask"):
        a, b = getattr(got, field), getattr(want, field)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype, field
    for t, jt in zip(got.terns, want.terns):
        np.testing.assert_array_equal(t.orig_eid, jt.orig_eid)


def test_lookup_many_splits_queries_by_mask():
    vals = np.arange(16, dtype=np.int32).reshape(2, 8)
    keys = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    mask = np.ones((2, 8), bool)
    mask[0, 5:] = False
    leds = [rounds.RoundLedger("a"), rounds.RoundLedger("b")]
    out = LocalDht().lookup_many(torch.from_numpy(vals),
                                 torch.from_numpy(keys), ledgers=leds,
                                 key_mask=mask)
    rounds.harvest_many(leds)
    jleds = [JaxLedger("a"), JaxLedger("b")]
    want = JaxLocalDht().lookup_many(vals, keys, ledgers=jleds,
                                     key_mask=mask)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert [led.summary() for led in leds] == [led.summary()
                                               for led in jleds]
    assert [led.dht_queries for led in leds] == [5, 8]
