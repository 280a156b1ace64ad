"""The port's four examples (``examples/torch_*.py``) run at their small
sizes on the CPU; the quickstart's and the clustering's results equal the
JAX package's engine on the same graphs, solve for solve."""
import importlib.util
from pathlib import Path

import numpy as np

from repro.ampc import AmpcEngine as JaxEngine
from repro.core import oracle as joracle
from repro.graph import generators as jgen
from repro.graph.coo import UGraph as JaxGraph

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reference_quickstart(tiny):
    """``examples/quickstart.py``'s solves on the JAX engine, at the port
    example's sizes."""
    log2, n_one, k_two, sizes = _load("torch_quickstart").SIZES[tiny]
    g = jgen.rmat(log2, 8.0, seed=0)
    eng = JaxEngine(dht_backend="local", epsilon=0.5, seed=0)
    out = {"n": g.n, "m": g.m}
    ra, rm = eng.solve(g, "mis"), eng.solve(g, "mis-mpc")
    out["mis"] = (int(ra.output.sum()), ra.shuffles,
                  float(ra.stats["cache_savings_factor"]), rm.shuffles)
    rmm = eng.solve(g, "matching")
    out["matching"] = (int(rmm.output.sum()), rmm.shuffles,
                       bool(joracle.is_maximal_matching(g, rmm.output)))
    gw = g.with_degree_weights()
    rf = eng.solve(gw, "msf", skip_ternarize_if_dense=False)
    rfm = eng.solve(gw, "msf-mpc")
    out["msf"] = (float(gw.weights[rf.output].sum()), rf.shuffles,
                  float(rf.stats["avg_queries_per_vertex"]), rfm.shuffles,
                  int(rfm.stats["phases"]))
    for name, cyc in [("one", jgen.one_cycle(n_one)),
                      ("two", jgen.two_cycles(k_two))]:
        ra = eng.solve(cyc, "one-vs-two", p=1 / 64)
        rm = eng.solve(cyc, "one-vs-two-mpc")
        out[f"1v2c_{name}"] = (ra.output, ra.shuffles, rm.output,
                               3 * int(rm.stats["phases"]))
    parts = jgen.disjoint_components(sizes, 4.0, seed=1)
    out["cc"] = int(eng.solve(parts, "connectivity").stats["num_components"])
    return out


def test_quickstart_equals_the_reference(capsys):
    got = _load("torch_quickstart").main(["--device", "cpu", "--tiny"])
    assert got == _reference_quickstart(True)
    assert got["cc"] == 3 and got["1v2c_one"][0] == 1
    assert "CC : 3 components (expected 3)" in capsys.readouterr().out


def test_graph_analytics_equals_the_reference():
    ex = _load("torch_graph_analytics")
    got = ex.main(["--device", "cpu", "--tiny"])
    assert got["purity"] > 0.95
    pts, _ = ex.make_clusters(per=50)
    g = ex.knn_graph(pts)
    jg = JaxGraph(g.n, g.edges, g.weights)
    eng = JaxEngine(seed=0)
    mask = eng.solve(jg, "msf", skip_ternarize_if_dense=False).output
    assert int(mask.sum()) == got["msf_edges"]
    fe = np.where(mask)[0]
    keep = np.ones(g.m, bool)
    keep[fe[np.argsort(-g.weights[fe])][:3]] = False
    labels = eng.solve(JaxGraph(g.n, g.edges[mask & keep]),
                       "connectivity").output
    np.testing.assert_array_equal(got["labels"], labels)


def test_train_lm_tiny_trains_and_resumes(tmp_path):
    ex = _load("torch_train_lm")
    ref = _load("train_lm")     # the reference's example: its configs
    for mine, theirs in ((ex.config_100m(), ref.config_100m()),
                         (ex.config_tiny(), ref.config_tiny())):
        assert mine.param_count() == theirs.param_count()
        assert {f: getattr(mine, f) for f in ("vocab", "n_layers", "d_model",
                                              "n_heads", "n_kv_heads",
                                              "head_dim", "d_ff")} == \
            {f: getattr(theirs, f) for f in ("vocab", "n_layers", "d_model",
                                             "n_heads", "n_kv_heads",
                                             "head_dim", "d_ff")}
    assert ex.config_100m().param_count() == 91_108_480
    args = ["--tiny", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    first = ex.main(args + ["--steps", "20"])
    assert first["start"] == 0 and first["last"] < first["first"]
    again = ex.main(args + ["--steps", "40"])
    assert again["start"] == 20


def test_serve_lm_serves_on_the_cpu(capsys):
    r = _load("torch_serve_lm").main(["--device", "cpu", "--batch", "2",
                                      "--prompt-len", "8", "--gen", "3",
                                      "--arch", "qwen3-4b"])
    assert r["generated"].shape == (2, 3)
    assert bool(r["logits"].float().isfinite().all())
    assert "sample continuation ids" in capsys.readouterr().out
