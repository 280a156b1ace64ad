"""The port's 1-vs-2-cycle primitives against the JAX package's (tolerance 0).

``cycle_adjacency`` (vectorized) array-equal to the reference's loop;
``_walk`` on the sampled lanes against the reference's walk over every
lane (successors, total steps, ``ok``) and each lane's steps against a
plain host walk; ``_count_components`` and ``_local_contraction_phase``
phase by phase.  Samples, ranks and relabellings are numpy draws from
seeds.  One case gives a 2-cycle tied float32 ranks, as ``rng.permutation``
ranks above 2^24 tie, and records what both packages do.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import one_vs_two as j1v2
from repro.graph import generators as jgen
from repro.graph.coo import UGraph as JaxGraph

from repro_torch.convert import graph_from_reference
from repro_torch.core import one_vs_two as t1v2


def _union(lengths, seed):
    """Disjoint cycles of the given lengths (2: a double edge, 1: a
    self-loop), vertices relabelled, edges shuffled and turned by a seed."""
    rng = np.random.default_rng(seed)
    parts, off = [], 0
    for k in lengths:
        c = np.arange(k)
        parts.append(np.stack([c, (c + 1) % k], 1) + off)
        off += k
    e = np.concatenate(parts)
    e = rng.permutation(off)[e]
    e = e[rng.permutation(len(e))]
    flip = rng.random(len(e)) < 0.5
    e[flip] = e[flip, ::-1]
    return JaxGraph(off, e.astype(np.int32))


GRAPHS = {
    "two_cycles60": lambda: jgen.two_cycles(60),
    "one_cycle101": lambda: jgen.one_cycle(101),
    "two_cycles2": lambda: jgen.two_cycles(2),
    "mixed": lambda: _union([1, 2, 3, 7, 40, 150], seed=3),
    "many": lambda: _union([5] * 30 + [64, 9, 2], seed=4),
}


def _sampled(n, p, seed):
    rng = np.random.default_rng(seed)
    s = rng.random(n) < p
    if not s.any():
        s[rng.integers(n)] = True
    return s


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_cycle_adjacency_is_array_equal(name):
    jg = GRAPHS[name]()
    got = t1v2.cycle_adjacency(graph_from_reference(jg))
    want = j1v2.cycle_adjacency(jg)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_cycle_adjacency_rejects_other_degrees():
    with pytest.raises(ValueError, match="union of cycles"):
        t1v2.cycle_adjacency(graph_from_reference(jgen.path(5)))


def _host_walk(nbr, sampled, v, d, max_steps):
    """The reference's per-lane walk, in plain Python."""
    prev, cur, steps = v, int(nbr[v, d]), 1
    while not sampled[cur] and steps < max_steps:
        prev, cur = cur, int(nbr[cur, 1] if nbr[cur, 0] == prev
                             else nbr[cur, 0])
        steps += 1
    return (cur if sampled[cur] else -1), steps


@pytest.mark.parametrize("max_steps", [None, 6])
@pytest.mark.parametrize("p", [1 / 8, 1 / 3])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_walk_on_sampled_lanes_matches_jax(name, p, max_steps):
    jg = GRAPHS[name]()
    n = jg.n
    nbr = j1v2.cycle_adjacency(jg)
    sampled = _sampled(n, p, seed=n)
    ms = max_steps or n + 1
    j0, j1, jsteps, jok = j1v2._walk(
        jnp.asarray(nbr), jnp.asarray(sampled),
        jnp.arange(n, dtype=jnp.int32), ms)
    lanes, succ, steps, done = t1v2._walk(
        torch.from_numpy(nbr), torch.from_numpy(sampled), ms)
    np.testing.assert_array_equal(lanes.numpy(), np.flatnonzero(sampled))
    np.testing.assert_array_equal(succ[0].numpy(), np.asarray(j0)[sampled])
    np.testing.assert_array_equal(succ[1].numpy(), np.asarray(j1)[sampled])
    assert int(steps.sum()) == int(jsteps)
    assert bool(done.all()) == bool(jok)
    for k, v in enumerate(np.flatnonzero(sampled)):
        for d in (0, 1):
            s, st = _host_walk(nbr, sampled, v, d, ms)
            assert (int(succ[d, k]), int(steps[d, k])) == (s, st)
            assert bool(done[d, k]) == (s >= 0)
    if max_steps is None:
        assert bool(jok)


@pytest.mark.parametrize("p", [1 / 8, 1 / 2])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_count_components_matches_jax(name, p):
    jg = GRAPHS[name]()
    n = jg.n
    nbr = j1v2.cycle_adjacency(jg)
    sampled = _sampled(n, p, seed=7)
    ids = jnp.arange(n, dtype=jnp.int32)
    j0, j1, _, ok = j1v2._walk(jnp.asarray(nbr), jnp.asarray(sampled), ids,
                               n + 1)
    assert bool(ok)
    # after earlier graphs' compilations, JAX 0.9.0 can run this jitted
    # count with a stale executable ("Execution supplied 4 buffers but
    # compiled program expected 5"); a fresh cache compiles it anew
    jax.clear_caches()
    want = j1v2._count_components(j0, j1, jnp.asarray(sampled), ids, n)
    got = t1v2._count_components(
        torch.tensor(np.asarray(j0)), torch.tensor(np.asarray(j1)),
        torch.from_numpy(sampled), n)
    assert int(got) == int(want) == len(np.unique(_labels(jg)[sampled]))


def _labels(jg):
    from repro.core import oracle as joracle
    return joracle.connected_components(jg)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_walk_and_count_counts_the_sampled_cycles(name):
    """Every vertex of a cycle with a sample is walked once from each
    side: 2 steps a vertex; the count is that of the sampled cycles."""
    jg = GRAPHS[name]()
    nbr = torch.from_numpy(j1v2.cycle_adjacency(jg))
    sampled = _sampled(jg.n, 1 / 8, seed=1)
    ncomp, steps, ok = t1v2._walk_and_count(nbr, torch.from_numpy(sampled),
                                            jg.n + 1)
    labels = _labels(jg)
    hit = np.isin(labels, labels[sampled])
    assert bool(ok)
    assert int(steps) == 2 * int(hit.sum())
    assert int(ncomp) == len(np.unique(labels[sampled]))


def _phases_both(nbr, rank, phases):
    """Run ``phases`` contraction phases in both packages; assert every
    phase's outputs equal; return the remaining counts."""
    n = nbr.shape[0]
    ja, jb = jnp.asarray(nbr[:, 0]), jnp.asarray(nbr[:, 1])
    jp = jnp.arange(n, dtype=jnp.int32)
    jal = jnp.ones((n,), bool)
    ta, tb = torch.from_numpy(nbr[:, 0].copy()), torch.from_numpy(
        nbr[:, 1].copy())
    tp = torch.arange(n, dtype=torch.int32)
    tal = torch.ones(n, dtype=torch.bool)
    jr, tr = jnp.asarray(rank), torch.from_numpy(rank)
    remaining = []
    for _ in range(phases):
        ja, jb, jp, jal, jrem = j1v2._local_contraction_phase(ja, jb, jp,
                                                              jal, jr)
        ta, tb, tp, tal, trem = t1v2._local_contraction_phase(ta, tb, tp,
                                                              tal, tr)
        for t, j in ((ta, ja), (tb, jb), (tp, jp), (tal, jal)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert int(trem) == int(jrem)
        remaining.append(int(trem))
    return remaining


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_local_contraction_phase_matches_jax(name):
    jg = GRAPHS[name]()
    nbr = j1v2.cycle_adjacency(jg)
    rank = np.random.default_rng(11).permutation(jg.n).astype(np.float32)
    remaining = _phases_both(nbr, rank, 40)
    assert remaining[-1] == 0


def test_tied_float32_ranks_never_contract_a_two_cycle():
    """Ranks ``rng.permutation(n).astype(np.float32)`` tie above 2^24:
    2^24 and 2^24 + 1 become the same float32.  A 2-cycle whose two
    vertices carry such ranks has no strict local minimum, so neither
    package ever contracts it: after 50 phases both still count its two
    vertices as remaining, where distinct ranks finish it in one phase.
    ``one_vs_two_mpc`` would run such a cycle to its 200-phase cap."""
    tied = np.array([2**24, 2**24 + 1], np.int64).astype(np.float32)
    assert tied[0] == tied[1]
    g = jgen.two_cycles(2)            # two 2-cycles: {0, 1} and {2, 3}
    nbr = j1v2.cycle_adjacency(g)
    rank = np.array([tied[0], tied[1], 5.0, 6.0], np.float32)
    remaining = _phases_both(nbr, rank, 50)
    assert remaining == [2] * 50
