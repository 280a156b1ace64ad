"""The benchmark's layout: every cell, configuration, traffic mix, limit
and per-layer metric found by name from its own file; BENCHMARK.json within
its contract; nothing of JAX or the JAX package reachable."""
import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = harness.benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = harness.cell(name, ROOT)
    assert cell.loop().run
    readers = cell.readers()
    assert readers and all(callable(r.read) for r in readers.values())
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2
    assert set(cell.limits) <= {"train": {"loss_gap", "grad_gap",
                                          "change_gap"},
                                "decode": {"token_gap", "kv_err"}
                                }[cell.mix["loop"]]


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert all(w in CELLS for w in m["workloads"])
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("perfbench/")
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert all(k in cfg for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_new_metric_file_is_found_without_edit(tmp_path):
    """A metric added as a file and an entry reaches its cell."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "steps_traced.train", "unit": "steps", "better": "higher",
         "source": "device_trace", "layer": "device",
         "moves": "train_tokens_per_s", "workloads": ["qwen3-4b.train_4k"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "perfbench" / "metrics" / "steps_traced.train.py"
     ).write_text("def read(trace):\n    return trace.steps\n")
    cell = harness.cell("qwen3-4b.train_4k", tmp_path)
    readers = cell.readers()
    assert "steps_traced.train" in readers
    assert readers["steps_traced.train"].read(
        type("T", (), {"steps": 3})()) == 3
    assert "steps_traced.train" not in harness.cell(
        "qwen3-4b.decode_32k", tmp_path).readers()


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (ROOT / "perfbench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_no_benchmark_file_imports_jax():
    for path in (ROOT / "perfbench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"repro", "jax", "jaxlib", "flax", "benchmarks"}, \
            path


def test_forbidden_modules_compare_whole_names(monkeypatch):
    fake = type(sys)("repro")
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", type(sys)("x"))
    assert "repro_torch_lookalike" not in harness.forbidden_modules(ROOT)
    monkeypatch.setitem(sys.modules, "repro", fake)
    assert "repro" in harness.forbidden_modules(ROOT)
    jax_sub = type(sys)("jax.numpy")
    monkeypatch.setitem(sys.modules, "jax.numpy", jax_sub)
    assert "jax.numpy" in harness.forbidden_modules(ROOT)


def test_run_refuses_without_a_card():
    """No CUDA: a non-zero exit and no result line."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         CELLS[0], "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_keeps_the_published_values(name):
    """A value the program fixes in its code stands under ``runs_as``; the
    cell runs it, and the file's own key keeps the published value."""
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    published = json.loads((ROOT / entry["file"]).read_text())
    cell = next(harness.cell(w["name"], ROOT) for w in BENCH["workloads"]
                if w["config"] == name)
    for key, value in published.get("runs_as", {}).items():
        assert cell.config[key] == value
        assert key not in entry["reduced"]
    assert all(cell.config[k] == v for k, v in published.items()
               if k not in published.get("runs_as", {}))
