"""The port's matching fixpoint against the JAX package's (tolerance 0).

``_mm_wave`` and ``_mm_fixpoint`` of ``repro_torch.core.matching`` against
``repro.core.matching`` on the seeded graphs of ``test_torch_engine.py``:
statuses, matched flags and every counter equal.  Ranks are numpy draws
from a seed handed to both sides; one case draws them from four values, so
ties are frequent.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import matching as jmm
from repro.graph import generators as jgen
from repro.graph.coo import UGraph as JaxGraph

from repro_torch.core import matching as tmm
from repro_torch.core import rounds

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
RANKS = ("permutation", "ties")


def _erank(m, kind, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(0, 4, m).astype(np.float32)
    return rng.permutation(m).astype(np.float32)


def _both(g, erank):
    """(jax u, v, rank), (torch u, v, rank) of one graph."""
    u, v = g.edges[:, 0], g.edges[:, 1]
    return ((jnp.asarray(u), jnp.asarray(v), jnp.asarray(erank)),
            (torch.from_numpy(u.copy()).long(),
             torch.from_numpy(v.copy()).long(), torch.from_numpy(erank)))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("kind", RANKS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_mm_fixpoint_matches_jax(name, kind):
    g = GRAPHS[name]()
    erank = _erank(g.m, kind)
    (ju, jv, jr), (tu, tv, tr) = _both(g, erank)
    want = jmm._mm_fixpoint(ju, jv, jr, g.n, jnp.zeros((g.m,), jnp.int32))
    reads0 = rounds.HOST_READS
    st, it, q0, q1 = tmm._mm_fixpoint(tu, tv, tr, g.n,
                                      torch.zeros(g.m, dtype=torch.int32))
    _eq(st, want[0])
    assert (it, int(q0), int(q1)) == tuple(int(x) for x in want[1:])
    assert q0.dtype == q1.dtype == torch.int64
    # one host read a wave, and one more that ends the loop
    assert rounds.HOST_READS - reads0 == it + 1
    if kind == "permutation":
        assert not (st == tmm.UNKNOWN).any()


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("kind", RANKS)
@pytest.mark.parametrize("name", ["er200", "rmat8", "star", "dense"])
def test_mm_wave_matches_jax(name, kind, active):
    """One wave from a mid-fixpoint state (two waves in, a few edges
    forced OUT), with and without an active-edge mask."""
    g = GRAPHS[name]()
    erank = _erank(g.m, kind)
    (ju, jv, jr), (tu, tv, tr) = _both(g, erank)
    st = jnp.zeros((g.m,), jnp.int32)
    for _ in range(2):
        st, _ = jmm._mm_wave(st, ju, jv, jr, g.n)
    rng = np.random.default_rng(9)
    st = np.asarray(st).copy()
    st[(st == 0) & (rng.random(g.m) < 0.1)] = tmm.OUT
    mask = rng.random(g.m) < 0.6 if active else None
    want = jmm._mm_wave(jnp.asarray(st), ju, jv, jr, g.n,
                        active_edge=None if mask is None
                        else jnp.asarray(mask))
    got = tmm._mm_wave(torch.from_numpy(st), tu, tv, tr, g.n,
                       active_edge=None if mask is None
                       else torch.from_numpy(mask))
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_mm_wave_leaves_a_vertex_without_unresolved_edges_at_inf():
    """``vmin`` of a vertex whose edges are all resolved reads +inf, as
    JAX's ``segment_min`` gives it: the one unresolved edge joins."""
    u = torch.tensor([0, 1, 2])
    v = torch.tensor([1, 2, 3])
    st = torch.tensor([tmm.OUT, tmm.UNKNOWN, tmm.OUT], dtype=torch.int32)
    new, matched = tmm._mm_wave(st, u, v, torch.tensor([0.0, 5.0, 1.0]), 4)
    assert new.tolist() == [tmm.OUT, tmm.IN, tmm.OUT]
    assert matched.tolist() == [0, 1, 1, 0]
