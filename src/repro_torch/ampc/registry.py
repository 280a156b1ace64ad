"""Problem registry: the AMPC problems the port can solve.

A copy of the JAX package's ``repro.ampc.registry``: a decorator registers
each solver with a normalized signature ``fn(ctx, graph, **opts)`` so
``AmpcEngine.solve(graph, "<name>")`` dispatches without per-algorithm
special cases.  Problems the reference registers but the port does not
solve yet raise a ``KeyError`` that names the ROADMAP item porting them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    name: str
    model: str                 # "ampc" | "mpc"
    fn: Callable               # fn(ctx, graph, **opts) -> (output, stats)
    output: str    # "vertex_mask" | "edge_mask" | "labels" | "count"
    needs_weights: bool = False
    needs_cycles: bool = False  # input must be a disjoint union of cycles
    baseline_of: Optional[str] = None  # for MPC baselines: the AMPC problem
    summary: str = ""
    # Table 3: expected shuffle count on the default (sparse) path, or None
    # when the count is input-dependent.
    table3_shuffles: Optional[int] = None


PROBLEMS: Dict[str, ProblemSpec] = {}
_ALIASES: Dict[str, str] = {}

# problem names (and aliases) of the JAX package not ported yet, with the
# ROADMAP item that ports them
NOT_PORTED: Dict[str, str] = {
    **dict.fromkeys(("matching", "mm", "maximal-matching", "weighted-matching",
                     "mwm", "vertex-cover"), "queue 1, item 5"),
    **dict.fromkeys(("one-vs-two", "1v2c"), "queue 1, item 6"),
    **dict.fromkeys(("mis-mpc", "matching-mpc", "matching-levels",
                     "matching-vertex-process", "msf-mpc", "msf-kkt",
                     "connectivity-mpc", "one-vs-two-mpc"), "queue 1, item 7"),
}


def problem(name: str, *, model: str, output: str, needs_weights: bool = False,
            needs_cycles: bool = False, baseline_of: Optional[str] = None,
            aliases: Tuple[str, ...] = (), summary: str = "",
            table3_shuffles: Optional[int] = None):
    """Register an algorithm under ``name`` (plus aliases)."""
    if model not in ("ampc", "mpc"):
        raise ValueError(f"model must be 'ampc' or 'mpc', got {model!r}")

    def deco(fn):
        spec = ProblemSpec(name=name, model=model, fn=fn, output=output,
                           needs_weights=needs_weights,
                           needs_cycles=needs_cycles, baseline_of=baseline_of,
                           summary=summary, table3_shuffles=table3_shuffles)
        if name in PROBLEMS or name in _ALIASES:
            raise ValueError(f"duplicate problem registration: {name}")
        # validate every alias before mutating, so a rejected registration
        # leaves the registry untouched
        taken = set(PROBLEMS) | set(_ALIASES) | {name}
        for a in aliases:
            if a in taken:
                raise ValueError(f"alias {a!r} collides with an existing "
                                 "problem or alias")
            taken.add(a)
        PROBLEMS[name] = spec
        for a in aliases:
            _ALIASES[a] = name
        return fn

    return deco


def _ensure_loaded():
    # Solvers self-register on import; lazy to avoid an import cycle.
    from . import solvers  # noqa: F401


def get(name: str) -> ProblemSpec:
    _ensure_loaded()
    key = _ALIASES.get(name, name)
    if key not in PROBLEMS:
        if name in NOT_PORTED:
            raise KeyError(
                f"problem {name!r} is not ported to repro_torch yet "
                f"(ROADMAP.md {NOT_PORTED[name]}); ported: {sorted(PROBLEMS)}")
        raise KeyError(
            f"unknown problem {name!r}; known: {sorted(PROBLEMS)} "
            f"(aliases: {sorted(_ALIASES)})")
    return PROBLEMS[key]


def names(model: Optional[str] = None):
    _ensure_loaded()
    return sorted(n for n, s in PROBLEMS.items()
                  if model is None or s.model == model)


def specs(model: Optional[str] = None):
    _ensure_loaded()
    return [PROBLEMS[n] for n in names(model)]
