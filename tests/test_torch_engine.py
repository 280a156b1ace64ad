"""The port's ``AmpcEngine.solve`` against the JAX package's (tolerance 0).

For ``mis``, ``connectivity`` and ``msf`` on every test graph: outputs,
stats and ledger summaries are equal (only ``wall_time_s`` and the
``phase_times`` values may differ), and the answers agree with the oracles.
Graphs are built by the JAX package's generators and carried across with
``repro_torch.convert``.
"""
import numpy as np
import pytest
import torch

from repro.ampc import AmpcEngine as JaxEngine
from repro.graph import generators as jgen
from repro.graph.coo import UGraph as JaxGraph

from repro_torch.ampc import AmpcEngine, registry
from repro_torch.ampc.engine import _field_eq
from repro_torch.convert import graph_from_arrays, graph_from_reference
from repro_torch.core import oracle, rounds
from repro_torch.obs.metrics import MetricsRegistry

GRAPHS = {
    "er200": lambda: jgen.erdos_renyi(200, 4.0, seed=1),
    "rmat8": lambda: jgen.rmat(8, 8.0, seed=1),
    "grid12": lambda: jgen.grid2d(12, 12),
    "components": lambda: jgen.disjoint_components([30, 45, 60], seed=2),
    "path": lambda: jgen.path(40),
    "star": lambda: jgen.star(50),
    "edgeless": lambda: JaxGraph(12, np.zeros((0, 2), np.int32)),
    "dense": lambda: jgen.erdos_renyi(40, 20.0, seed=3),
}
SPARSE_MSF = {"skip_ternarize_if_dense": False}
CASES = (
    [(g, "mis", {}) for g in GRAPHS]
    + [(g, "connectivity", {}) for g in GRAPHS]
    + [(g, "msf", {}) for g in GRAPHS if g != "edgeless"]
    + [("dense", "msf", SPARSE_MSF), ("rmat8", "msf", SPARSE_MSF)]
)


@pytest.fixture(scope="module")
def engines():
    return JaxEngine(seed=0), AmpcEngine(seed=0, device="cpu")


def _inputs(name, problem):
    jg = GRAPHS[name]()
    if problem == "msf":
        jg = jg.with_random_weights(2)
    return jg, graph_from_reference(jg)


def _ledger_equal(a, b):
    a, b = dict(a), dict(b)
    for led in (a, b):
        led.pop("wall_time_s")
    pa, pb = a.pop("phase_times"), b.pop("phase_times")
    return a == b and list(pa) == list(pb)


@pytest.mark.parametrize("name,problem,opts", CASES,
                         ids=[f"{g}-{p}{'-sparse' if o else ''}"
                              for g, p, o in CASES])
def test_solve_matches_jax_engine_and_oracle(engines, name, problem, opts):
    jax_eng, eng = engines
    jg, tg = _inputs(name, problem)
    want = jax_eng.solve(jg, problem, **opts)
    calls = []
    rounds.HARVEST_HOOK = calls.append
    try:
        got = eng.solve(tg, problem, **opts)
    finally:
        rounds.HARVEST_HOOK = None
    assert (got.problem, got.model, got.backend) == \
        (want.problem, want.model, want.backend)
    np.testing.assert_array_equal(got.output, want.output)
    assert got.output.dtype == np.asarray(want.output).dtype
    assert _field_eq(got.stats, want.stats), (got.stats, want.stats)
    assert _ledger_equal(got.ledger, want.ledger), (got.ledger, want.ledger)
    # one device-to-host harvest per solve (none for the trivial m == 0 cc)
    trivial = problem == "connectivity" and tg.m == 0
    assert len(calls) == (0 if trivial else 1)

    if problem == "mis":
        rank = np.random.default_rng(0).permutation(tg.n)
        np.testing.assert_array_equal(got.output, oracle.greedy_mis(tg, rank))
        assert oracle.is_mis(tg, got.output)
    elif problem == "connectivity":
        np.testing.assert_array_equal(got.output,
                                      oracle.connected_components(tg))
    else:
        np.testing.assert_array_equal(got.output, oracle.kruskal_msf(tg)[0])
    if tg.m and (problem != "msf" or opts or got.stats["path"] == "sparse"):
        assert got.shuffles == registry.get(problem).table3_shuffles


def test_dense_graph_takes_both_msf_paths(engines):
    _, eng = engines
    tg = graph_from_reference(GRAPHS["dense"]().with_random_weights(2))
    dense = eng.solve(tg, "msf")
    sparse = eng.solve(tg, "msf", **SPARSE_MSF)
    assert dense.stats["path"] == "dense" and dense.shuffles == 1
    assert sparse.stats["path"] == "sparse" and sparse.shuffles == 5
    np.testing.assert_array_equal(dense.output, sparse.output)


@pytest.mark.parametrize("problem", ["mis", "connectivity", "msf"])
def test_trace_spans_match_jax_engine(problem):
    jg, tg = _inputs("er200", problem)
    want = JaxEngine(seed=0, trace=True, metrics=False).solve(jg, problem)
    got = AmpcEngine(seed=0, trace=True, metrics=False,
                     device="cpu").solve(tg, problem)

    def names(span):
        return [s.name for s in span.walk()]

    assert names(got.trace) == names(want.trace)
    events = [e.name for s in got.trace.walk() for e in s.events]
    assert events == [e.name for s in want.trace.walk() for e in s.events]


def test_harvest_returns_mixed_leaves_exactly():
    """The one-transfer harvest packs tensors of every dtype a solve hands
    it (bool, int32, int64, float32, 0-d) beside host values, and returns
    each leaf unchanged, after the queued records."""
    led = rounds.RoundLedger("t")
    led.record_queries_deferred(torch.tensor(7), torch.tensor(7) * 36,
                                deduped_away=torch.tensor(2))
    leaves = (torch.tensor([True, False, True]),
              torch.arange(5, dtype=torch.int32).reshape(5, 1),
              torch.tensor(2**40, dtype=torch.int64),
              torch.tensor([0.5, -1.25], dtype=torch.float32), 3)
    host = led.harvest(leaves)
    for got, want in zip(host[:4], leaves[:4]):
        assert got.dtype == want.numpy().dtype
        np.testing.assert_array_equal(got, want.numpy())
    assert host[4] == 3
    assert (led.dht_queries, led.dht_bytes, led.dedup_savings) == (7, 252, 2)
    assert led.harvest() is None and len(led.device) == 0


def test_metrics_report_counts_solves():
    eng = AmpcEngine(seed=0, device="cpu", metrics=MetricsRegistry())
    eng.solve(graph_from_reference(GRAPHS["path"]()), "mis")
    report = eng.metrics_report()
    assert "solves_total" in report and "dht_queries_total" in report


def test_engine_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AmpcEngine()
    with pytest.raises(RuntimeError):
        AmpcEngine(device="cuda")
    assert AmpcEngine(device="cpu").device.type == "cpu"


def test_unported_surface_names_its_roadmap_item():
    eng = AmpcEngine(device="cpu")
    g = graph_from_arrays(3, np.array([[0, 1], [1, 2]]))
    with pytest.raises(KeyError, match="ROADMAP"):
        eng.solve(g, "matching")
    with pytest.raises(KeyError, match="unknown problem"):
        eng.solve(g, "no-such-problem")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AmpcEngine(dht_backend="routed", device="cpu")
    for call in (lambda: eng.solve_many([g], "mis"),
                 lambda: eng.session(g), lambda: eng.submit(g, "mis")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    with pytest.raises(ValueError, match="weights"):
        eng.solve(g, "msf")
    assert eng.problems() == ["connectivity", "mis", "msf"]
    assert eng.solve(g, "cc").problem == "connectivity"


def test_graph_from_arrays_copies_and_casts():
    edges = np.array([[0, 1], [1, 2]], np.int64)
    w = np.array([1.5, 2.5])
    g = graph_from_arrays(3, edges, w)
    edges[0, 0] = 9
    assert g.edges.dtype == np.int32 and g.edges[0, 0] == 0
    assert g.weights.dtype == np.float32 and g.m == 2
