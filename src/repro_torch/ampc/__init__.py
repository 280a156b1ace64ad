"""The port's AMPC session API (PyTorch, CUDA by default)::

    from repro_torch.ampc import AmpcEngine
    res = AmpcEngine().solve(g, "connectivity")          # on the card
    res = AmpcEngine(device="cpu").solve(g, "mis")       # on the host

Every problem the JAX package registers (``AmpcEngine().problems()``: the
AMPC problems and their MPC baselines); the local DHT backend.
"""
from .backends import DhtBackend, LocalDht, resolve_backend
from .engine import AmpcEngine, AmpcResult, SolveContext
from .registry import ProblemSpec, get as get_problem, \
    names as problem_names, problem, specs as problem_specs

__all__ = [
    "AmpcEngine", "AmpcResult", "SolveContext",
    "DhtBackend", "LocalDht", "resolve_backend",
    "ProblemSpec", "problem", "get_problem", "problem_names",
    "problem_specs",
]
