"""Finds a cell's pieces by name and runs it.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- a configuration: the entry's ``file`` (``perfbench/configs/<name>.json``),
  its published values with, under ``runs_as``, those that the program
  fixes in its code in their place (both sides run those);
- a traffic mix: ``perfbench/traffic/<mix>.json``, whose ``loop`` names the
  general loop that drives it, ``perfbench/loops/<loop>.py``;
- a cell's limits on the comparison that decides ``correct``:
  ``perfbench/limits/<cell>.json``;
- a per-layer metric: ``perfbench/metrics/<metric>.py``, whose
  ``read(trace)`` returns its value or None.

A later change adds a cell, a mix or a metric as new files and entries;
no file here needs an edit for it.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    def loop(self):
        """The loop module that drives this cell's traffic."""
        return importlib.import_module(f"perfbench.loops.{self.mix['loop']}")

    def readers(self) -> Dict[str, object]:
        """Each per-layer metric of this cell, by name, to its reader."""
        out = {}
        for m in self.per_layer:
            path = self.root / "perfbench" / "metrics" / f"{m['name']}.py"
            spec = importlib.util.spec_from_file_location(
                f"perfbench.metrics.{m['name']}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out[m["name"]] = mod
        return out


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its
    configuration, traffic mix, limits and metrics."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
    w = work[name]
    config_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in names
                                  else [])]
    config = load_json(root / config_entry["file"])
    return Cell(name=name, chips=w["chips"],
                config={**config, **config.get("runs_as", {})},
                mix=load_json(root / "perfbench" / "traffic"
                              / f"{w['traffic']}.json"),
                limits=load_json(root / "perfbench" / "limits"
                                 / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, root=root)


def forbidden_modules(root: Path = ROOT) -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN_TOP``
    (compared whole: ``repro_torch`` is not ``repro``), or whose file
    lies under the repository's ``benchmarks/``."""
    found = []
    bench = str(root / "benchmarks") + "/"
    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] in FORBIDDEN_TOP:
            found.append(name)
            continue
        path = getattr(mod, "__file__", None) or ""
        if path.startswith(bench):
            found.append(name)
    return sorted(found)


def checks_line(checks: Dict[str, dict]) -> List[str]:
    return [f"check {name}: {c['value']!r} limit {c['limit']!r}"
            for name, c in checks.items()]


def judge(checks: Dict[str, dict]) -> bool:
    """Every number within its limit (a NaN never is)."""
    return all(c["value"] <= c["limit"] for c in checks.values())
