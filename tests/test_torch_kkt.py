"""The port's KKT filter machinery against the JAX package's (tolerance 0).

``rmq_build``/``rmq_query``, ``root_forest``, ``_lift_tables``,
``path_max_queries`` and ``f_light_edges`` of ``repro_torch.core.kkt_filter``
against ``repro.core.kkt_filter`` on forests of seeded graphs, where the
reference's int32 arc key ``src * 2K + arc`` does not wrap.  One case goes
past the wrap (n · 2K = 2^33), where the reference is not run: the port's
``parent`` and ``depth`` there equal a host BFS.
"""
import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import kkt_filter as jkkt
from repro.core import oracle as joracle
from repro.core.rounds import RoundLedger as JaxLedger
from repro.graph import generators as jgen

from repro_torch.convert import graph_from_reference
from repro_torch.core import kkt_filter as tkkt
from repro_torch.core.msf import boruvka_inround
from repro_torch.core.rounds import RoundLedger

GRAPHS = {
    "er": lambda: jgen.erdos_renyi(150, 3.0, seed=1).with_random_weights(7),
    "rmat": lambda: jgen.rmat(8, 6.0, seed=2).with_random_weights(3),
    "grid": lambda: jgen.grid2d(9, 11).with_random_weights(4),
    "components": lambda: jgen.disjoint_components(
        [20, 35, 50], seed=2).with_random_weights(5),
    "star": lambda: jgen.star(40).with_random_weights(6),
    "path": lambda: jgen.path(60).with_random_weights(8),
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("k", [1, 2, 5, 37, 100])
def test_rmq_matches_jax_and_brute_force(k, dtype):
    rng = np.random.default_rng(k)
    a = rng.integers(-50, 50, k).astype(dtype)
    want = jkkt.rmq_build(jnp.asarray(a))
    got = tkkt.rmq_build(torch.from_numpy(a))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    i, j = np.triu_indices(k)
    i, j = i.astype(np.int32), j.astype(np.int32)
    q = tkkt.rmq_query(got, torch.from_numpy(i), torch.from_numpy(j))
    np.testing.assert_array_equal(
        _np(q), np.asarray(jkkt.rmq_query(want, jnp.asarray(i),
                                          jnp.asarray(j))))
    np.testing.assert_array_equal(
        _np(q), [a[x:y + 1].min() for x, y in zip(i, j)])


def _forest(g, pad=0):
    """The MSF of ``g`` as (fu, fv, fw, fvalid) numpy arrays, shuffled and
    turned by a seed, with ``pad`` invalid lanes appended."""
    mask, _ = joracle.kruskal_msf(g)
    rng = np.random.default_rng(g.n)
    e, w = g.edges[mask], g.weights[mask]
    order = rng.permutation(len(e))
    e, w = e[order], w[order]
    flip = rng.random(len(e)) < 0.5
    e[flip] = e[flip, ::-1]
    valid = np.ones(len(e), bool)
    if pad:
        e = np.concatenate([e, rng.integers(0, g.n, (pad, 2))]).astype(
            np.int32)
        w = np.concatenate([w, np.full(pad, 7.0, np.float32)])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
    return (e[:, 0].astype(np.int32), e[:, 1].astype(np.int32),
            w.astype(np.float32), valid)


def _both_rooted(g, pad):
    fu, fv, fw, fvalid = _forest(g, pad)
    want = jkkt.root_forest(*(jnp.asarray(x) for x in (fu, fv, fw, fvalid)),
                            g.n)
    got = tkkt.root_forest(*(torch.from_numpy(x) for x in (fu, fv, fw,
                                                           fvalid)), g.n)
    return (fu, fv, fw, fvalid), want, got


@pytest.mark.parametrize("pad", [0, 5])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_root_forest_matches_jax(name, pad):
    g = GRAPHS[name]()
    assert g.n * 2 * (g.m + pad) < 2**31   # the reference's key fits
    _, want, got = _both_rooted(g, pad)
    for t, j in zip(got, want):
        assert _np(t).dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(_np(t), np.asarray(j))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_path_max_queries_match_jax(name):
    g = GRAPHS[name]()
    (fu, fv, fw, fvalid), want, got = _both_rooted(g, 0)
    K = len(fu)
    _, comp, _ = boruvka_inround(
        torch.from_numpy(fu), torch.from_numpy(fv), torch.from_numpy(fw),
        torch.arange(K, dtype=torch.int32), torch.from_numpy(fvalid), g.n, K)
    levels = tkkt._doublings(g.n)
    anc, mx = tkkt._lift_tables(got[0], got[1], levels)
    janc, jmx = jkkt._lift_tables(want[0], want[1], levels)
    np.testing.assert_array_equal(_np(anc), np.asarray(janc))
    np.testing.assert_array_equal(_np(mx), np.asarray(jmx))
    qu, qv = g.edges[:, 0].copy(), g.edges[:, 1].copy()
    maxw, same = tkkt.path_max_queries(*got, comp, torch.from_numpy(qu),
                                       torch.from_numpy(qv), levels)
    jmaxw, jsame = jkkt.path_max_queries(
        *want, jnp.asarray(comp.numpy()), jnp.asarray(qu), jnp.asarray(qv),
        levels)
    np.testing.assert_array_equal(_np(maxw), np.asarray(jmaxw))
    np.testing.assert_array_equal(_np(same), np.asarray(jsame))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_f_light_edges_match_jax(name):
    g = GRAPHS[name]()
    rng = np.random.default_rng(3)
    sample = rng.random(g.m) < 0.3
    h = type(g)(g.n, g.edges[sample], g.weights[sample])
    fmask = np.zeros(g.m, bool)
    fmask[np.flatnonzero(sample)[joracle.kruskal_msf(h)[0]]] = True
    jled, tled = JaxLedger("f"), RoundLedger("f")
    want = jkkt.f_light_edges(g, fmask, ledger=jled)
    got = tkkt.f_light_edges(graph_from_reference(g), fmask, ledger=tled,
                             device="cpu")
    np.testing.assert_array_equal(got, want)
    a, b = tled.summary(), jled.summary()
    for led in (a, b):
        led.pop("wall_time_s")
        led.pop("phase_times")
    assert a == b
    # F-light keeps every edge of the true MSF
    assert got[joracle.kruskal_msf(g)[0]].all()


def _bfs(n, fu, fv):
    """Host BFS from the first vertex of each tree's lowest-numbered edge:
    (parent, depth), roots and isolated vertices their own parent."""
    adj = collections.defaultdict(list)
    for a, b in zip(fu.tolist(), fv.tolist()):
        adj[a].append(b)
        adj[b].append(a)
    parent = np.arange(n, dtype=np.int32)
    depth = np.zeros(n, np.int32)
    seen = np.zeros(n, bool)
    for root in fu.tolist():
        if seen[root]:
            continue
        seen[root] = True
        queue = collections.deque([root])
        while queue:
            x = queue.popleft()
            for y in adj[x]:
                if not seen[y]:
                    seen[y] = True
                    parent[y] = x
                    depth[y] = depth[x] + 1
                    queue.append(y)
    return parent, depth


def test_root_forest_past_the_int32_key_wrap_equals_a_host_bfs():
    """Four paths of 2^13 edges on n = 2^17 vertices: n · 2K = 2^33, where
    the reference's key src * 2K + arc wraps in int32."""
    n, K = 2**17, 2**15
    assert n * 2 * K == 2**33
    rng = np.random.default_rng(0)
    verts = rng.permutation(n)[:K + 4].reshape(4, -1)
    e = np.concatenate([np.stack([p[:-1], p[1:]], 1) for p in verts])
    e = e[rng.permutation(K)]
    flip = rng.random(K) < 0.5
    e[flip] = e[flip, ::-1]
    fu, fv = e[:, 0].astype(np.int32), e[:, 1].astype(np.int32)
    fw = rng.random(K).astype(np.float32)
    parent, parent_w, depth = tkkt.root_forest(
        torch.from_numpy(fu), torch.from_numpy(fv), torch.from_numpy(fw),
        torch.ones(K, dtype=torch.bool), n)
    want_parent, want_depth = _bfs(n, fu, fv)
    np.testing.assert_array_equal(parent.numpy(), want_parent)
    np.testing.assert_array_equal(depth.numpy(), want_depth)
    # each non-root vertex's parent weight is its parent edge's
    w_of = {}
    for a, b, w in zip(fu.tolist(), fv.tolist(), fw.tolist()):
        w_of[(a, b)] = w_of[(b, a)] = w
    child = np.flatnonzero(want_parent != np.arange(n))
    np.testing.assert_array_equal(
        parent_w.numpy()[child],
        np.array([w_of[(c, want_parent[c])] for c in child], np.float32))
