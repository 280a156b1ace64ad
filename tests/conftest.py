"""Test-suite conftest: deterministic fallback for ``hypothesis``.

The property tests use a small slice of the hypothesis API
(``given`` / ``settings`` / ``strategies.integers|floats|lists|data``).
When the real package is unavailable (this container does not ship it), we
register a minimal deterministic stand-in under ``sys.modules`` so the four
property-test modules still collect and run: each ``@given`` test executes
``max_examples`` times with seeded numpy randomness instead of being
skipped wholesale.  With hypothesis installed this file is a no-op.
"""
from __future__ import annotations


import sys
import types

try:  # pragma: no cover - exercised only when hypothesis exists
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import numpy as np

    class _Strategy:
        def __init__(self, sample):
            self.sample = sample

    def integers(lo, hi):
        return _Strategy(lambda rng: int(rng.integers(lo, hi + 1)))

    def floats(lo, hi):
        return _Strategy(lambda rng: float(rng.uniform(lo, hi)))

    def lists(elem, min_size=0, max_size=10):
        def sample(rng):
            k = int(rng.integers(min_size, max_size + 1))
            return [elem.sample(rng) for _ in range(k)]
        return _Strategy(sample)

    class _Data:
        def __init__(self, rng):
            self._rng = rng

        def draw(self, strategy):
            return strategy.sample(self._rng)

    def data():
        return _Strategy(lambda rng: _Data(rng))

    def given(*strategies):
        def deco(fn):
            # zero-arg wrapper: pytest must not mistake drawn args for fixtures
            def wrapper():
                for i in range(wrapper._max_examples):
                    rng = np.random.default_rng(i)
                    fn(*[s.sample(rng) for s in strategies])
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            # honor @settings whether it wraps @given or sits under it
            wrapper._max_examples = getattr(fn, "_max_examples", 10)
            return wrapper
        return deco

    def settings(max_examples=10, **_ignored):
        def deco(fn):
            fn._max_examples = max_examples
            return fn
        return deco

    st_mod = types.ModuleType("hypothesis.strategies")
    st_mod.integers = integers
    st_mod.floats = floats
    st_mod.lists = lists
    st_mod.data = data

    hyp_mod = types.ModuleType("hypothesis")
    hyp_mod.given = given
    hyp_mod.settings = settings
    hyp_mod.strategies = st_mod
    hyp_mod.__is_fallback__ = True

    sys.modules["hypothesis"] = hyp_mod
    sys.modules["hypothesis.strategies"] = st_mod


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where CUDA is missing")
