"""The port's ``GraphSession`` solves against the JAX package's (tolerance 0).

Every ``SNAPSHOT_PROBLEMS`` entry, solved cold and then warm through one
session of each package, on ``tests/test_snapshot_sessions.py``'s graphs
(a sparse weighted graph, the dense-msf graph, two cycles): outputs, stats
(the ``snapshot`` stat without its process-global ``key``) and ledger
summaries (times left out) are equal, and both equal a plain ``solve``'s
output.  Also ``invalidate``, ``clear_cache``, ``cache_info("snapshot")``,
alias resolution and problems a session passes through unchanged.
"""
import numpy as np
import pytest
import torch

from repro.ampc import AmpcEngine as JaxEngine
from repro.graph import generators as jgen

from repro_torch.ampc import AmpcEngine, SNAPSHOT_PROBLEMS, registry
from repro_torch.ampc.engine import _field_eq
from repro_torch.convert import graph_from_reference
from repro_torch.core import rounds

GRAPHS = {
    "sparse": lambda: jgen.erdos_renyi(60, 2.0, seed=1).with_random_weights(
        seed=101),
    "dense": lambda: jgen.erdos_renyi(40, 14.0, seed=2).with_random_weights(
        seed=5),
    "er80": lambda: jgen.erdos_renyi(80, 3.0, seed=2).with_random_weights(3),
    "two_cycles32": lambda: jgen.two_cycles(32),
}
CASES = ([(p, g) for g in ("sparse", "er80")
          for p in sorted(SNAPSHOT_PROBLEMS - {"one-vs-two"})]
         + [("msf", "dense"), ("connectivity", "dense"),
            ("one-vs-two", "two_cycles32")])


def _ledger_equal(a, b):
    a, b = dict(a), dict(b)
    for led in (a, b):
        led.pop("wall_time_s")
    pa, pb = a.pop("phase_times"), b.pop("phase_times")
    return a == b and list(pa) == list(pb)


def _without_key(stats):
    stats = dict(stats)
    stats["snapshot"] = {k: v for k, v in stats["snapshot"].items()
                         if k != "key"}
    return stats


@pytest.mark.parametrize("problem,graph", CASES,
                         ids=[f"{p}-{g}" for p, g in CASES])
def test_session_solves_match_jax_sessions(problem, graph):
    jg = GRAPHS[graph]()
    tg = graph_from_reference(jg)
    opts = {"p": 1 / 8} if problem == "one-vs-two" else {}
    jeng = JaxEngine(seed=0, metrics=False)
    eng = AmpcEngine(seed=0, device="cpu", metrics=False)
    jsess, sess = jeng.session(jg), eng.session(tg)
    plain = eng.solve(tg, problem, **opts).output
    shuffles = []
    for call, hit in (("cold", False), ("warm", True)):
        want = jsess.solve(problem, **opts)
        calls = []
        rounds.HARVEST_HOOK = calls.append
        try:
            got = sess.solve(problem, **opts)
        finally:
            rounds.HARVEST_HOOK = None
        assert len(calls) == 1, call
        np.testing.assert_array_equal(got.output, want.output)
        np.testing.assert_array_equal(got.output, plain)
        assert got.stats["snapshot"] == {"hit": hit, "key": sess.key,
                                         "supported": True}
        assert _field_eq(_without_key(got.stats), _without_key(want.stats)), \
            (call, got.stats, want.stats)
        assert _ledger_equal(got.ledger, want.ledger), (call, got.ledger,
                                                        want.ledger)
        shuffles.append(got.shuffles)
    # the cold solve writes its view under one shuffle; the warm one skips it
    assert shuffles == [2, 1]
    info, jinfo = eng.cache_info("snapshot"), jeng.cache_info("snapshot")
    assert (info.hits, info.misses, info.size) == \
        (jinfo.hits, jinfo.misses, jinfo.size) == (1, 1, 1)


def test_one_session_serves_every_view():
    """One session on a weighted graph: the graph-KV view serves mis and
    the matching family, msf and connectivity build their own views; the
    snapshot cache counts one miss a view and one hit a reuse, as the JAX
    engine's does."""
    jg = GRAPHS["sparse"]()
    eng, jeng = AmpcEngine(seed=0, device="cpu"), JaxEngine(seed=0)
    sess, jsess = eng.session(graph_from_reference(jg)), jeng.session(jg)
    order = ["mis", "matching", "msf", "connectivity", "vertex-cover",
             "weighted-matching", "msf", "connectivity"]
    hits = [sess.solve(p).stats["snapshot"]["hit"] for p in order]
    jhits = [jsess.solve(p).stats["snapshot"]["hit"] for p in order]
    assert hits == jhits == [False, True, False, False, True, True, True,
                             True]
    info, jinfo = eng.cache_info("snapshot"), jeng.cache_info("snapshot")
    assert (info.hits, info.misses, info.size) == \
        (jinfo.hits, jinfo.misses, jinfo.size) == (5, 3, 3)
    assert sess.invalidate() == 3 and sess.invalidate() == 0
    assert sess.solve("msf").stats["snapshot"]["hit"] is False


def test_invalidate_after_clear_cache_rebuilds():
    eng = AmpcEngine(seed=0, device="cpu")
    sess = eng.session(graph_from_reference(GRAPHS["sparse"]()))
    sess.solve("msf")
    eng.clear_cache()
    info = eng.cache_info(kind="snapshot")
    assert (info.hits, info.misses, info.size) == (0, 0, 0)
    assert sess.invalidate() == 0
    res = sess.solve("msf")
    assert res.stats["snapshot"]["hit"] is False
    assert res.ledger["shuffles"] == 2


def test_cache_info_unknown_kind_raises():
    eng = AmpcEngine(seed=0, device="cpu")
    for kind in ("bogus", ""):
        with pytest.raises(ValueError, match="solver"):
            eng.cache_info(kind=kind)


def test_alias_resolution_and_unsupported_problems():
    eng, jeng = AmpcEngine(seed=0, device="cpu"), JaxEngine(seed=0)
    jg = jgen.erdos_renyi(30, 3.0, seed=0)
    sess, jsess = eng.session(graph_from_reference(jg)), jeng.session(jg)
    for name in registry.names() + sorted(registry._ALIASES):
        assert sess._supported(name) == jsess._supported(name), name
    for name in ("cc", "mm", "1v2c", "ampc-mis", "mwm"):
        assert sess._supported(name), name
    assert SNAPSHOT_PROBLEMS == {s.name for s in registry.specs()
                                 if sess._supported(s.name)}
    res = sess.solve("matching-levels")
    assert res.stats["snapshot"] == {"hit": False, "supported": False}
    np.testing.assert_array_equal(
        res.output, eng.solve(sess.graph, "matching-levels").output)
    assert eng.cache_info("snapshot").misses == 0


def test_session_views_live_on_the_engine_device():
    eng = AmpcEngine(seed=0, device="cpu")
    sess = eng.session(graph_from_reference(GRAPHS["sparse"]()))
    led = rounds.RoundLedger("t")
    entries, hit = sess.snapshot.materialize_tern(led, unit=True)
    assert not hit and led.shuffles == 1
    assert all(t.device == eng.device for k, t in entries.items()
               if k != "tg")
    assert entries["first_slot"].dtype == torch.int32
