"""The port's AMPC session API (PyTorch, CUDA by default)::

    from repro_torch.ampc import AmpcEngine
    res = AmpcEngine().solve(g, "connectivity")          # on the card
    res = AmpcEngine(device="cpu").solve(g, "mis")       # on the host
    results = AmpcEngine().solve_many(graphs, "mis")     # batched serving
    fut = AmpcEngine().submit(g, "mis")                  # async serving
    sess = AmpcEngine().session(g)                       # snapshot reuse
    AmpcEngine(dht_backend="routed")                     # the router
    AmpcEngine(deferred_accounting=False)                # eager ledgers

Every problem the JAX package registers (``AmpcEngine().problems()``: the
AMPC problems and their MPC baselines), the batch adapters of its
``solve_many``, its snapshot sessions and its async worker pool; both DHT
backends, the local gather and the all-to-all router over shards
(``RoutedDht(repro_torch.core.dht.make_mesh(8))`` for 8), and both
accounting modes.
"""
from .async_engine import AmpcFuture
from .backends import DhtBackend, LocalDht, RoutedDht, resolve_backend
from .cache import CacheInfo, SolverCache
from .engine import AmpcEngine, AmpcResult, BatchSolveContext, SolveContext
from .registry import ProblemSpec, batched_impl, get as get_problem, \
    names as problem_names, problem, specs as problem_specs
from .session import GraphSession, GraphSnapshot, SNAPSHOT_PROBLEMS

__all__ = [
    "AmpcEngine", "AmpcResult", "SolveContext", "BatchSolveContext",
    "AmpcFuture", "GraphSession", "GraphSnapshot", "SNAPSHOT_PROBLEMS",
    "DhtBackend", "LocalDht", "RoutedDht", "resolve_backend",
    "CacheInfo", "SolverCache",
    "ProblemSpec", "problem", "batched_impl", "get_problem", "problem_names",
    "problem_specs",
]
