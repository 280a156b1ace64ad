"""The port's ``AmpcEngine.solve`` against the JAX package's (tolerance 0).

For every problem the reference registers, on every test graph the JAX
engine solves (the cycle problems on two cycles of 60 and one of 101):
outputs, stats and ledger summaries are equal (only ``wall_time_s`` and the
``phase_times`` values may differ), and the answers agree with the oracles
as ``tests/test_engine.py::_oracle_check`` holds them.  Graphs are built by
the JAX package's generators and carried across with ``repro_torch.convert``.
"""
import numpy as np
import pytest
import torch

from repro.ampc import AmpcEngine as JaxEngine
from repro.ampc import registry as jregistry
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
CYCLES = {
    "two_cycles60": lambda: jgen.two_cycles(60),
    "one_cycle101": lambda: jgen.one_cycle(101),
}
SPARSE_MSF = {"skip_ternarize_if_dense": False}
WALK = {"p": 1 / 8}
ALL_GRAPHS = ["matching", "weighted-matching", "vertex-cover",
              "matching-levels", "matching-vertex-process", "mis-mpc",
              "matching-mpc", "msf-mpc", "connectivity-mpc"]
CASES = (
    [(g, "mis", {}) for g in GRAPHS]
    + [(g, "connectivity", {}) for g in GRAPHS]
    + [(g, "msf", {}) for g in GRAPHS if g != "edgeless"]
    + [("dense", "msf", SPARSE_MSF), ("rmat8", "msf", SPARSE_MSF)]
    + [(g, p, {}) for p in ALL_GRAPHS for g in GRAPHS]
    # the reference's sample step draws rng.integers(0) on an edgeless graph
    + [(g, "msf-kkt", {}) for g in GRAPHS if g != "edgeless"]
    + [(g, "one-vs-two", WALK) for g in CYCLES]
    + [(g, "one-vs-two-mpc", {}) for g in CYCLES]
)
# device-to-host harvests a solve makes: msf-kkt's two inner msf solves
# and its path-max read
HARVESTS = {"msf-kkt": 3}


def _case_id(name, problem, opts):
    return f"{name}-{problem}{'-sparse' if opts is SPARSE_MSF else ''}"


@pytest.fixture(scope="module")
def engines():
    return JaxEngine(seed=0), AmpcEngine(seed=0, device="cpu")


def _inputs(name, problem):
    jg = {**GRAPHS, **CYCLES}[name]()
    if registry.get(problem).needs_weights:
        jg = jg.with_random_weights(2)
    return jg, graph_from_reference(jg)


def _ledger_equal(a, b):
    a, b = dict(a), dict(b)
    for led in (a, b):
        led.pop("wall_time_s")
    pa, pb = a.pop("phase_times"), b.pop("phase_times")
    return a == b and list(pa) == list(pb)


def _oracle_check(problem, g, res):
    """The answer against the port's oracles, as the reference's
    ``tests/test_engine.py::_oracle_check`` checks its own."""
    out = res.output
    if problem in ("mis", "mis-mpc"):
        rank = np.random.default_rng(0).permutation(g.n)
        np.testing.assert_array_equal(out, oracle.greedy_mis(g, rank))
        assert oracle.is_mis(g, out)
    elif problem in ("matching", "matching-levels", "matching-vertex-process",
                     "matching-mpc", "weighted-matching"):
        np.testing.assert_array_equal(
            out, oracle.greedy_mm(g, res.stats["erank"]))
        assert oracle.is_maximal_matching(g, out)
    elif problem == "vertex-cover":
        mm = oracle.greedy_mm(g, res.stats["erank"])
        cover = np.zeros(g.n, bool)
        cover[g.edges[mm, 0]] = True
        cover[g.edges[mm, 1]] = True
        np.testing.assert_array_equal(out, cover)
    elif problem in ("connectivity", "connectivity-mpc"):
        np.testing.assert_array_equal(out, oracle.connected_components(g))
    elif problem in ("msf", "msf-kkt", "msf-mpc"):
        np.testing.assert_array_equal(out, oracle.kruskal_msf(g)[0])
    elif problem in ("one-vs-two", "one-vs-two-mpc"):
        assert out == oracle.num_components(g)
    else:  # a new problem must add an oracle here
        raise AssertionError(f"no oracle check for {problem}")


@pytest.mark.parametrize("name,problem,opts", CASES,
                         ids=[_case_id(*c) for c in CASES])
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
    assert np.asarray(got.output).dtype == np.asarray(want.output).dtype
    assert _field_eq(got.stats, want.stats), (got.stats, want.stats)
    assert _ledger_equal(got.ledger, want.ledger), (got.ledger, want.ledger)
    # one device-to-host harvest per solve (none for the trivial m == 0 cc)
    trivial = problem == "connectivity" and tg.m == 0
    assert len(calls) == (0 if trivial else HARVESTS.get(problem, 1))

    _oracle_check(problem, tg, got)
    table3 = registry.get(problem).table3_shuffles
    if table3 is not None and tg.m and (
            problem != "msf" or opts or got.stats["path"] == "sparse"):
        assert got.shuffles == table3


def test_dense_graph_takes_both_msf_paths(engines):
    _, eng = engines
    tg = graph_from_reference(GRAPHS["dense"]().with_random_weights(2))
    dense = eng.solve(tg, "msf")
    sparse = eng.solve(tg, "msf", **SPARSE_MSF)
    assert dense.stats["path"] == "dense" and dense.shuffles == 1
    assert sparse.stats["path"] == "sparse" and sparse.shuffles == 5
    np.testing.assert_array_equal(dense.output, sparse.output)


def _trace_input(problem):
    if registry.get(problem).needs_cycles:
        return ("two_cycles60", WALK if problem == "one-vs-two" else {})
    return "er200", {}


@pytest.mark.parametrize("problem", registry.names())
def test_trace_spans_match_jax_engine(problem):
    name, opts = _trace_input(problem)
    jg, tg = _inputs(name, problem)
    want = JaxEngine(seed=0, trace=True, metrics=False).solve(jg, problem,
                                                              **opts)
    got = AmpcEngine(seed=0, trace=True, metrics=False,
                     device="cpu").solve(tg, problem, **opts)

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
    with pytest.raises(KeyError, match="unknown problem"):
        eng.solve(g, "no-such-problem")
    # the serving layers and the routed backend are ported: each gives the
    # solve's answer
    want = eng.solve(g, "mis").output
    routed = AmpcEngine(dht_backend="routed", device="cpu").solve(g, "mis")
    assert routed.backend == "routed"
    np.testing.assert_array_equal(routed.output, want)
    with AmpcEngine(device="cpu") as served:
        for res in (served.solve_many([g], "mis")[0],
                    served.session(g).solve("mis"),
                    served.submit(g, "mis").result(timeout=60)):
            np.testing.assert_array_equal(res.output, want)
    with pytest.raises(ValueError, match="weights"):
        eng.solve(g, "msf")
    assert eng.problems() == [
        "connectivity", "connectivity-mpc", "matching", "matching-levels",
        "matching-mpc", "matching-vertex-process", "mis", "mis-mpc", "msf",
        "msf-kkt", "msf-mpc", "one-vs-two", "one-vs-two-mpc", "vertex-cover",
        "weighted-matching"]
    assert eng.solve(g, "cc").problem == "connectivity"


def test_registry_equals_the_reference_registry():
    """Every problem and alias of ``repro.ampc.registry``, with the same
    declared kind, needs, baseline and Table-3 count."""
    assert registry.names() == jregistry.names()
    for model in ("ampc", "mpc"):
        assert registry.names(model) == jregistry.names(model)
    assert registry._ALIASES == jregistry._ALIASES
    fields = ("model", "output", "needs_weights", "needs_cycles",
              "baseline_of", "summary", "table3_shuffles")
    for name in registry.names():
        got, want = registry.get(name), jregistry.get(name)
        assert [getattr(got, f) for f in fields] == \
            [getattr(want, f) for f in fields], name
    for alias, name in jregistry._ALIASES.items():
        assert registry.get(alias).name == name


@pytest.mark.parametrize("problem", registry.names())
def test_baseline_for_matches_jax_engine(engines, problem):
    jax_eng, eng = engines
    assert eng.baseline_for(problem) == jax_eng.baseline_for(problem)


@pytest.mark.parametrize("problem", ["mis", "matching", "msf",
                                     "connectivity", "one-vs-two"])
def test_mpc_baselines_use_more_shuffles(engines, problem):
    _, eng = engines
    base = eng.baseline_for(problem)
    assert base is not None, f"no MPC baseline registered for {problem}"
    spec = registry.get(problem)
    if spec.needs_cycles:
        tg = graph_from_reference(CYCLES["two_cycles60"]())
        opts = WALK
    else:
        tg = graph_from_reference(jgen.erdos_renyi(120, 3.0, seed=2))
        opts = SPARSE_MSF if problem == "msf" else {}
    if spec.needs_weights:
        tg = tg.with_random_weights(3)
    ampc = eng.solve(tg, problem, **opts)
    mpc = eng.solve(tg, base)
    assert mpc.shuffles > ampc.shuffles, (problem, ampc.shuffles,
                                          mpc.shuffles)
    np.testing.assert_array_equal(mpc.output, ampc.output)


@pytest.mark.parametrize("problem", ["one-vs-two", "one-vs-two-mpc", "1v2c"])
def test_cycle_problems_need_a_union_of_cycles(engines, problem):
    _, eng = engines
    path = graph_from_reference(jgen.path(10))
    with pytest.raises(ValueError, match="disjoint union of cycles"):
        eng.solve(path, problem)


def test_graph_from_arrays_copies_and_casts():
    edges = np.array([[0, 1], [1, 2]], np.int64)
    w = np.array([1.5, 2.5])
    g = graph_from_arrays(3, edges, w)
    edges[0, 0] = 9
    assert g.edges.dtype == np.int32 and g.edges[0, 0] == 0
    assert g.weights.dtype == np.float32 and g.m == 2
