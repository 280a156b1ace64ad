"""Port MSF primitives and host layout against the JAX package (tolerance 0).

Graphs come from the JAX package's generators and cross through
``repro_torch.convert``; ranks and weights are numpy draws from a seed,
handed to both sides.  Weight ties are included: ``argmin`` takes the first
minimum and the contraction sort is stable in both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import msf as jmsf
from repro.core.ternarize import ternarize as jternarize
from repro.graph import generators as jgen

from repro_torch.convert import graph_from_reference
from repro_torch.core import msf as tmsf
from repro_torch.core.ternarize import ternarize as tternarize
from repro_torch.graph import generators as tgen


def _tied(g, seed):
    """Weights from three values: many ties."""
    w = np.random.default_rng(seed).integers(1, 4, g.m).astype(np.float32)
    return type(g)(g.n, g.edges, w)


GRAPHS = {
    "er": lambda: jgen.erdos_renyi(150, 4.0, seed=1).with_random_weights(7),
    "rmat": lambda: jgen.rmat(8, 6.0, seed=2).with_random_weights(3),
    "grid_ties": lambda: _tied(jgen.grid2d(10, 9), 5),
    "star_ties": lambda: _tied(jgen.star(40), 2),
    "rmat_ties": lambda: _tied(jgen.rmat(7, 8.0, seed=4), 6),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def tern(request):
    jg = GRAPHS[request.param]()
    jt = jternarize(jg)
    tt = tternarize(graph_from_reference(jg))
    return request.param, jt, tt


def _eq(t, j):
    np.testing.assert_array_equal(
        t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
        np.asarray(j))


def test_ternarize_and_padded_adj_are_array_equal(tern):
    _, jt, tt = tern
    _eq(tt.g.edges, jt.g.edges)
    _eq(tt.g.weights, jt.g.weights)
    _eq(tt.orig_eid, jt.orig_eid)
    _eq(tt.node_of, jt.node_of)
    assert (tt.g.n, tt.n_orig, tt.m_orig) == (jt.g.n, jt.n_orig, jt.m_orig)
    for a, b in zip(tt.g.padded_adj(3), jt.g.padded_adj(3)):
        _eq(a, b)


def test_padded_adj_unbounded_degree_is_array_equal():
    jg = jgen.rmat(7, 8.0, seed=9).with_random_weights(1)
    tg = graph_from_reference(jg)
    for md in (None, 2, 5):
        for a, b in zip(tg.padded_adj(md), jg.padded_adj(md)):
            _eq(a, b)


def _prim_inputs(jt, seed=0, epsilon=0.5):
    nt = jt.g.n
    rank = np.random.default_rng(seed).permutation(nt).astype(np.float32)
    budget = max(2, int(np.ceil(nt ** (epsilon / 2.0))))
    return jt.g.padded_adj(3), rank, budget


def test_truncated_prim_matches_jax(tern):
    _, jt, _ = tern
    (nbr, nbw, nbe), rank, budget = _prim_inputs(jt)
    j = jmsf.truncated_prim(jnp.asarray(nbr), jnp.asarray(nbw),
                            jnp.asarray(nbe), jnp.asarray(rank), budget)
    t = tmsf.truncated_prim(torch.from_numpy(nbr), torch.from_numpy(nbw),
                            torch.from_numpy(nbe), torch.from_numpy(rank),
                            budget)
    for a, b in zip(t, j):  # eids, hooks, cases, queries
        _eq(a, b)


@pytest.mark.parametrize("capacity_extra", [0, 3])
def test_truncated_prim_capped_matches_jax(capacity_extra):
    jt = jternarize(GRAPHS["rmat_ties"]())
    (nbr, nbw, nbe), rank, budget = _prim_inputs(jt, seed=3)
    cap = budget + capacity_extra
    j = jmsf.truncated_prim_capped(jnp.asarray(nbr), jnp.asarray(nbw),
                                   jnp.asarray(nbe), jnp.asarray(rank),
                                   budget, cap)
    t = tmsf.truncated_prim_capped(
        torch.from_numpy(nbr), torch.from_numpy(nbw), torch.from_numpy(nbe),
        torch.from_numpy(rank), budget, cap)
    for a, b in zip(t, j):
        _eq(a, b)


def test_pointer_jump_contract_and_boruvka_match_jax(tern):
    """The Algorithm-2 pipeline after Prim, stage by stage."""
    _, jt, _ = tern
    (nbr, nbw, nbe), rank, budget = _prim_inputs(jt, seed=1)
    _, hooks, _, _ = jmsf.truncated_prim(
        jnp.asarray(nbr), jnp.asarray(nbw), jnp.asarray(nbe),
        jnp.asarray(rank), budget)
    nt = jt.g.n
    parent = np.where(np.asarray(hooks) >= 0, np.asarray(hooks),
                      np.arange(nt)).astype(np.int32)
    j_roots, j_it = jmsf.pointer_jump(jnp.asarray(parent))
    t_roots, t_it = tmsf.pointer_jump(torch.from_numpy(parent))
    _eq(t_roots, j_roots)
    assert t_it == int(j_it)

    u, v = jt.g.edges[:, 0], jt.g.edges[:, 1]
    valid = np.ones(jt.g.m, bool)
    j_c = jmsf.contract_edges(*(jnp.asarray(a) for a in (
        u, v, jt.g.weights, jt.orig_eid, valid)), j_roots)
    t_c = tmsf.contract_edges(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in (u, v, jt.g.weights, jt.orig_eid,
                                          valid)), t_roots)
    for a, b in zip(t_c, j_c):  # cu, cv, w, eid, keep, live
        _eq(a, b)

    m = max(jt.m_orig, 1)
    j_mask, j_labels, j_phases = jmsf.boruvka_inround(*j_c[:5], nt, m)
    t_mask, t_labels, t_phases = tmsf.boruvka_inround(*t_c[:5], nt, m)
    _eq(t_mask, j_mask)
    _eq(t_labels, j_labels)
    assert t_phases == int(j_phases)


def test_boruvka_on_an_edgeless_graph():
    e = torch.zeros(0, dtype=torch.int32)
    mask, labels, phases = tmsf.boruvka_inround(
        e, e, torch.zeros(0), e, torch.zeros(0, dtype=torch.bool), 5, 1)
    assert phases == 1 and not mask.any()
    assert torch.equal(labels, torch.arange(5, dtype=torch.int32))


@pytest.mark.parametrize("name,make_j,make_t", [
    ("rmat", lambda: jgen.rmat(9, 8.0, seed=1),
     lambda: tgen.rmat(9, 8.0, seed=1)),
    ("er", lambda: jgen.erdos_renyi(300, 4.0, seed=2),
     lambda: tgen.erdos_renyi(300, 4.0, seed=2)),
    ("grid", lambda: jgen.grid2d(7, 9), lambda: tgen.grid2d(7, 9)),
    ("path", lambda: jgen.path(17), lambda: tgen.path(17)),
    ("star", lambda: jgen.star(17), lambda: tgen.star(17)),
    ("cycle", lambda: jgen.cycle(11),
     lambda: tgen.cycle(11)),
    ("disjoint", lambda: jgen.disjoint_components([20, 30], seed=4),
     lambda: tgen.disjoint_components([20, 30], seed=4)),
])
def test_generators_are_array_equal(name, make_j, make_t):
    jg, tg = make_j(), make_t()
    assert tg.n == jg.n
    _eq(tg.edges, jg.edges)
    _eq(tg.with_random_weights(3).weights, jg.with_random_weights(3).weights)
    _eq(tg.degrees(), jg.degrees())
    for a, b in zip(tg.csr(), jg.csr()):
        _eq(a, b)
