"""Problem registry: the AMPC problems the port can solve.

A copy of the JAX package's ``repro.ampc.registry``: a decorator registers
each solver with a normalized signature ``fn(ctx, graph, **opts)`` so
``AmpcEngine.solve(graph, "<name>")`` dispatches without per-algorithm
special cases.  The port registers every problem and alias the reference
does.

A problem may also carry a *batch adapter* (``@batched_impl``) with
signature ``fn(bctx, batch, **opts)``; ``AmpcEngine.solve_many`` runs it
once per shape bucket and falls back to sequential ``solve`` calls when it
is absent.
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
    # solve_many's adapter: fn(bctx, batch, **opts) -> [(output, stats), ...]
    # in batch order; None => sequential solves
    batch_fn: Optional[Callable] = None


PROBLEMS: Dict[str, ProblemSpec] = {}
_ALIASES: Dict[str, str] = {}


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


def batched_impl(name: str):
    """Attach a batch-safe ``solve_many`` adapter to a registered problem.

    The adapter receives ``(bctx, batch, **opts)`` — an
    ``engine.BatchSolveContext`` and a ``graph.batching.GraphBatch`` — and
    returns one ``(output, stats)`` pair per graph in the batch, in batch
    order.  Problems without an adapter fall back to sequential ``solve``
    calls inside ``solve_many``.
    """

    def deco(fn):
        key = _ALIASES.get(name, name)
        if key not in PROBLEMS:
            raise KeyError(f"cannot attach batch adapter: unknown problem "
                           f"{name!r}")
        if PROBLEMS[key].batch_fn is not None:
            raise ValueError(f"duplicate batch adapter for {key!r}")
        PROBLEMS[key] = dataclasses.replace(PROBLEMS[key], batch_fn=fn)
        return fn

    return deco


def _ensure_loaded():
    # Solvers self-register on import; lazy to avoid an import cycle.
    from . import solvers  # noqa: F401


def get(name: str) -> ProblemSpec:
    _ensure_loaded()
    key = _ALIASES.get(name, name)
    if key not in PROBLEMS:
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
