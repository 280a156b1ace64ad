"""The port's routed DHT backend against the JAX package's (tolerance 0).

The router is exact integer bookkeeping, so every comparison is equality:

  (a) ``core.dht.routed_lookup`` at 1 shard against the JAX
      ``routed_lookup`` in this process (dedup on and off, capacities from 1
      up, 1-D and (n, 3) values, -1 keys);
  (b) at 8 shards against the JAX ``routed_lookup`` in one subprocess that
      sets ``--xla_force_host_platform_device_count=8`` before importing
      jax, on key batches a multiple of 8: outputs, distinct counts and
      overflows; and the JAX 8-device engine's ``mis`` (output and every
      ledger counter) against the port's at 8 shards;
  (c) ``ShardedDHT(mesh=...)`` at 2, 3 and 8 shards, with row and key
      counts that are not multiples of the shard count (where the JAX
      package raises), against a numpy model of per-shard dedup and owner
      buckets;
  (d) every registered problem through ``solve``, ``solve_many``, a
      session (cold, then warm) and ``submit`` on the routed backend at 1
      shard, equal to the JAX routed engine: outputs, stats and every
      ``summary()`` counter but the wall times;
  (e) at 8 shards the same outputs as the port's local backend, with no
      overflow;
  (f) a capacity-starved ``RoutedDht.lookup_many`` records its overflows on
      every graph's ledger.

The reference's ``routed_lookup`` runs its ``shard_map`` op by op when it
is not jitted, some 6 s a call on the CPU; the JAX side here calls it under
``jax.jit`` (the same function, compiled once per shape).
"""
import collections
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ampc import AmpcEngine as JaxEngine
from repro.core import dht as jdht
from repro.graph import generators as jgen

from repro_torch.ampc import AmpcEngine, RoutedDht, registry, resolve_backend
from repro_torch.ampc.engine import _field_eq
from repro_torch.convert import graph_from_reference
from repro_torch.core import dht as tdht
from repro_torch.core.rounds import RoundLedger

_jit_routed = jax.jit(jdht.routed_lookup, static_argnums=(2, 3, 4, 5))


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_router():
    """The reference's engine and ``ShardedDHT`` reach ``routed_lookup``
    through their module; point it at the jitted function."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdht, "routed_lookup", _jit_routed)
        yield


def _values(n, wide, seed):
    rng = np.random.default_rng(seed)
    shape = (n, 3) if wide else (n,)
    return rng.integers(-1000, 1000, shape).astype(np.int32)


def _keys(n, q, seed):
    """Keys in [-1, n): padding, duplicates, every owner."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-1, n, q).astype(np.int32)
    keys[: q // 4] = keys[q // 4: 2 * (q // 4)]
    return keys


def _port_routed(values, keys, P, capacity, dedup):
    out, nu, ov = tdht.routed_lookup(torch.from_numpy(values),
                                     torch.from_numpy(keys),
                                     tdht.make_mesh(P), "dht",
                                     capacity=capacity, dedup=dedup)
    return out.numpy(), int(nu), int(ov)


# ----------------------------------------------------------- (a) 1 shard
@pytest.mark.parametrize("wide", [False, True], ids=["1d", "n3"])
@pytest.mark.parametrize("capacity", [None, 1, 2, 5])
@pytest.mark.parametrize("dedup", [True, False])
def test_routed_lookup_one_shard_matches_jax(dedup, capacity, wide):
    values, keys = _values(37, wide, 1), _keys(37, 50, 2)
    mesh = jax.make_mesh((1,), ("dht",))
    j_out, j_nu, j_ov = _jit_routed(jnp.asarray(values), jnp.asarray(keys),
                                    mesh, "dht", capacity, dedup)
    out, nu, ov = _port_routed(values, keys, 1, capacity, dedup)
    np.testing.assert_array_equal(out, np.asarray(j_out))
    assert (nu, ov) == (int(j_nu), int(j_ov))
    if capacity is None:
        assert ov == 0
        valid = keys >= 0
        np.testing.assert_array_equal(out[valid], values[keys[valid]])
        assert (out[~valid] == 0).all()


# ---------------------------------------------------------- (b) 8 shards
# (name, n, q, wide, dedup, capacity): n and q multiples of 8, as the JAX
# router asks
EIGHT_SHARD_CASES = [
    ("distributed_data", 64, 64, "f32x4", True, None),
    ("distributed_data_cap1", 64, 64, "f32x4", True, 1),
    ("distributed_data_nodedup", 64, 64, "f32x4", False, None),
    ("padded_1d", 40, 96, "1d", True, None),
    ("padded_1d_cap1", 40, 96, "1d", True, 1),
    ("padded_1d_cap2_nodedup", 40, 96, "1d", False, 2),
    ("padded_n3_cap3", 80, 160, "n3", True, 3),
]

SUBPROCESS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.core import dht
    assert len(jax.devices()) == 8
    dht.routed_lookup = jax.jit(dht.routed_lookup,
                                static_argnums=(2, 3, 4, 5))
    mesh = jax.make_mesh((8,), ("dht",))
    data = np.load(sys.argv[1])
    counts = {}
    outs = {}
    for name in json.loads(sys.argv[2]):
        cap = int(data[name + "_cap"])
        out, nu, ov = dht.routed_lookup(
            jnp.asarray(data[name + "_values"]),
            jnp.asarray(data[name + "_keys"]), mesh, "dht", cap or None,
            bool(data[name + "_dedup"]))
        outs[name] = np.asarray(out)
        counts[name] = [int(nu), int(ov)]
    from repro.ampc import AmpcEngine
    from repro.graph import generators as gen
    res = AmpcEngine(mesh=mesh, dht_backend="routed", seed=0).solve(
        gen.erdos_renyi(96, 3.0, seed=1), "mis")
    outs["mis"] = np.asarray(res.output)
    np.savez(sys.argv[3], **outs)
    ledger = {k: v for k, v in res.ledger.items()
              if k not in ("wall_time_s", "phase_times")}
    ledger["phases"] = list(res.ledger["phase_times"])
    print("RESULT " + json.dumps({"counts": counts, "mis_ledger": ledger,
                                  "mis_stats": res.stats}))
""")


def _eight_shard_input(name, n, q, kind):
    rng = np.random.default_rng(0)
    if kind == "f32x4":
        # tests/test_dht_distributed.py's data
        values = rng.random((n, 4)).astype(np.float32)
        keys = rng.integers(0, n, q).astype(np.int32)
        keys[5] = keys[6] = keys[7]
        return values, keys
    seed = sum(map(ord, name))
    return _values(n, kind == "n3", seed), _keys(n, q, seed + 1)


@pytest.fixture(scope="module")
def eight_devices(tmp_path_factory):
    """The JAX router and engine on 8 virtual devices, in one process."""
    tmp = tmp_path_factory.mktemp("routed8")
    inputs = {}
    for name, n, q, kind, dedup, cap in EIGHT_SHARD_CASES:
        values, keys = _eight_shard_input(name, n, q, kind)
        inputs.update({name + "_values": values, name + "_keys": keys,
                       name + "_dedup": dedup, name + "_cap": cap or 0})
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    names = [c[0] for c in EIGHT_SHARD_CASES]
    proc = subprocess.run(
        [sys.executable, "-c", SUBPROCESS, str(tmp / "in.npz"),
         json.dumps(names), str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    result = json.loads(line[-1][len("RESULT "):])
    return inputs, dict(np.load(tmp / "out.npz")), result


@pytest.mark.parametrize("name,n,q,kind,dedup,cap", EIGHT_SHARD_CASES,
                         ids=[c[0] for c in EIGHT_SHARD_CASES])
def test_routed_lookup_eight_shards_matches_jax(eight_devices, name, n, q,
                                                kind, dedup, cap):
    inputs, outs, result = eight_devices
    out, nu, ov = _port_routed(inputs[name + "_values"],
                               inputs[name + "_keys"], 8, cap, dedup)
    np.testing.assert_array_equal(out, outs[name])
    assert [nu, ov] == result["counts"][name]


def test_routed_lookup_eight_shards_counts_on_the_distributed_data(
        eight_devices):
    """The numbers the JAX router gives on tests/test_dht_distributed.py's
    data: 57 per-shard distinct keys, no overflow; 13 at capacity 1."""
    inputs, _, result = eight_devices
    counts = result["counts"]
    assert counts["distributed_data"] == [57, 0]
    assert counts["distributed_data_cap1"] == [57, 13]
    assert counts["distributed_data_nodedup"] == [64, 0]


def test_engine_mis_eight_shards_matches_jax(eight_devices):
    _, outs, result = eight_devices
    g = graph_from_reference(jgen.erdos_renyi(96, 3.0, seed=1))
    res = AmpcEngine(mesh=tdht.make_mesh(8), dht_backend="routed", seed=0,
                     device="cpu").solve(g, "mis")
    np.testing.assert_array_equal(res.output, outs["mis"])
    ledger = {k: v for k, v in res.ledger.items()
              if k not in ("wall_time_s", "phase_times")}
    ledger["phases"] = list(res.ledger["phase_times"])
    assert ledger == result["mis_ledger"]
    assert ledger["dht_overflows"] == 0 and ledger["shuffles"] == 2
    assert _field_eq(json.loads(json.dumps(res.stats)), result["mis_stats"])


# ------------------------------------ (c) ShardedDHT against a numpy model
def _model(values, keys, P, capacity, dedup):
    """Per-shard dedup and owner buckets, written out plainly: the rows are
    padded with zeros to a multiple of P and the keys with -1; shard p
    sends its own run of keys, each owner's bucket filled in ascending key
    order (dedup) or the caller's order, ``capacity`` slots a bucket.
    Returns (out, n_unique, overflow)."""
    n, q = values.shape[0], keys.shape[0]
    n_pad, q_pad = -(-n // P) * P, -(-q // P) * P
    rows = np.zeros((n_pad,) + values.shape[1:], values.dtype)
    rows[:n] = values
    k = np.full(q_pad, -1, np.int64)
    k[:q] = keys
    size, q_local = n_pad // P, q_pad // P
    cap = capacity or q_local
    out = np.zeros((q_pad,) + values.shape[1:], values.dtype)
    n_unique = overflow = 0
    for p in range(P):
        mine = k[p * q_local:(p + 1) * q_local]
        if dedup:
            sent = sorted({int(x) for x in mine if x >= 0})
            items = [(x, x) for x in sent]
        else:
            items = [(i, int(x)) for i, x in enumerate(mine) if x >= 0]
        n_unique += len(items)
        buckets = collections.Counter()
        answered = {}
        for item, key in items:
            slot = buckets[key // size]
            buckets[key // size] += 1
            if slot < cap:
                answered[item] = rows[key]
            else:
                overflow += 1
        for i, key in enumerate(mine):
            item = int(key) if dedup else i
            if key >= 0 and item in answered:
                out[p * q_local + i] = answered[item]
    return out[:q], n_unique, overflow


@pytest.mark.parametrize("wide", [False, True], ids=["1d", "n3"])
@pytest.mark.parametrize("capacity", [None, 1, 2])
@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("P", [2, 3, 8])
def test_sharded_dht_routed_matches_numpy_model(P, dedup, capacity, wide):
    values, keys = _values(29, wide, P), _keys(29, 45, P + 7)
    ledger = RoundLedger("routed")
    dht = tdht.ShardedDHT(torch.from_numpy(values), ledger=ledger,
                          mesh=tdht.make_mesh(P), capacity=capacity)
    assert dht.backend == "routed"
    out = dht.lookup(torch.from_numpy(keys), dedup=dedup)
    want, n_unique, overflow = _model(values, keys, P, capacity, dedup)
    np.testing.assert_array_equal(out.numpy(), want)
    valid = int((keys >= 0).sum())
    assert ledger.dht_queries == n_unique
    assert ledger.dht_bytes == n_unique * (values[0].nbytes + 4)
    assert ledger.dedup_savings == (valid - n_unique if dedup else 0)
    assert ledger.dht_overflows == overflow
    assert ledger.dht_query_waves == 1
    if capacity is None:
        assert overflow == 0


def test_routed_router_refuses_ragged_shards():
    with pytest.raises(ValueError, match="divide evenly"):
        tdht.routed_lookup(torch.zeros(10), torch.zeros(8, dtype=torch.int32),
                           tdht.make_mesh(4), "dht")
    with pytest.raises(ValueError):
        tdht.make_mesh(0)
    mesh = tdht.make_mesh(3, "shards")
    assert mesh.shape["shards"] == 3 and mesh.axis_names == ("shards",)


def test_routed_backend_surface():
    assert isinstance(resolve_backend("routed"), RoutedDht)
    mesh = tdht.make_mesh(4)
    backend = resolve_backend("routed", mesh=mesh)
    assert backend.mesh is mesh and backend.axis_name == "dht"
    assert repr(backend) == "RoutedDht(axis='dht', shards=4)"
    # without a mesh: one shard for host values
    snap = RoutedDht().snapshot(torch.arange(5))
    assert snap.backend == "routed" and snap.mesh.shape["dht"] == 1
    eng = AmpcEngine(mesh=mesh, dht_backend="routed", device="cpu")
    assert eng.mesh is mesh and eng.dht.mesh is mesh
    with pytest.raises(ValueError, match="unknown dht_backend"):
        resolve_backend("gossip")


# ------------------------------- (d) every entry point at 1 shard vs JAX
def _jax_graph(problem):
    spec = registry.get(problem)
    if spec.needs_cycles:
        return [jgen.two_cycles(30), jgen.one_cycle(56)]
    graphs = [jgen.erdos_renyi(60, 3.0, seed=2),
              jgen.erdos_renyi(56, 3.5, seed=4)]
    if spec.needs_weights:
        graphs = [g.with_random_weights(3) for g in graphs]
    return graphs


def _opts(problem):
    return {"p": 1 / 8} if problem == "one-vs-two" else {}


def _ledger(led):
    led = dict(led)
    led.pop("wall_time_s")
    led["phase_times"] = list(led["phase_times"])
    return led


def _stats(stats):
    stats = {k: v for k, v in stats.items() if k != "async"}
    if "snapshot" in stats:
        stats["snapshot"] = {k: v for k, v in stats["snapshot"].items()
                             if k != "key"}
    return stats


def _same(got, want):
    assert (got.problem, got.model, got.backend) == \
        (want.problem, want.model, want.backend)
    np.testing.assert_array_equal(got.output, want.output)
    assert _field_eq(_stats(got.stats), _stats(want.stats)), \
        (got.stats, want.stats)
    assert _ledger(got.ledger) == _ledger(want.ledger), \
        (got.ledger, want.ledger)


ENTRY_POINTS = ["solve", "solve_many", "session", "submit"]


def _run(entry, eng, graphs, problem, opts):
    """Results of one entry point: each graph's solve, the fleet's
    solve_many, a session's cold then warm solve, a submit of each."""
    if entry == "solve":
        return [eng.solve(g, problem, **opts) for g in graphs]
    if entry == "solve_many":
        return eng.solve_many(graphs, problem, **opts)
    if entry == "session":
        sess = eng.session(graphs[0])
        return [sess.solve(problem, **opts), sess.solve(problem, **opts)]
    return [eng.submit(g, problem, **opts).result(timeout=300)
            for g in graphs]


@pytest.fixture(scope="module")
def routed_engines():
    with JaxEngine(dht_backend="routed", seed=0, metrics=False,
                   max_workers=1) as jeng, \
            AmpcEngine(dht_backend="routed", seed=0, metrics=False,
                       device="cpu", max_workers=1) as eng:
        yield jeng, eng


@pytest.mark.parametrize("entry", ENTRY_POINTS)
@pytest.mark.parametrize("problem", registry.names())
def test_routed_engine_matches_jax_routed_engine(routed_engines, problem,
                                                 entry):
    jeng, eng = routed_engines
    jgraphs = _jax_graph(problem)
    graphs = [graph_from_reference(g) for g in jgraphs]
    want = _run(entry, jeng, jgraphs, problem, _opts(problem))
    got = _run(entry, eng, graphs, problem, _opts(problem))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.backend == "routed"
        _same(g, w)
        assert g.ledger["dht_overflows"] == 0


# ------------------------------------------- (e) 8 shards against local
@pytest.mark.parametrize("problem", registry.names())
def test_eight_shard_solve_equals_local(problem):
    graphs = [graph_from_reference(g) for g in _jax_graph(problem)]
    local = AmpcEngine(seed=0, device="cpu", metrics=False)
    routed = AmpcEngine(mesh=tdht.make_mesh(8), dht_backend="routed",
                        seed=0, device="cpu", metrics=False)
    for g in graphs:
        want = local.solve(g, problem, **_opts(problem))
        got = routed.solve(g, problem, **_opts(problem))
        np.testing.assert_array_equal(got.output, want.output)
        assert got.ledger["dht_overflows"] == 0
        assert got.shuffles == want.shuffles
        # each shard counts its own distinct keys: never fewer in all
        assert got.ledger["dht_queries"] >= want.ledger["dht_queries"]


@pytest.mark.parametrize("problem", ["mis", "connectivity", "msf"])
def test_eight_shard_serving_equals_local(problem):
    graphs = [graph_from_reference(g) for g in _jax_graph(problem)]
    with AmpcEngine(seed=0, device="cpu", metrics=False) as local, \
            AmpcEngine(mesh=tdht.make_mesh(8), dht_backend="routed", seed=0,
                       device="cpu", metrics=False) as routed:
        for entry in ENTRY_POINTS:
            want = _run(entry, local, graphs, problem, {})
            got = _run(entry, routed, graphs, problem, {})
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.output, w.output)
                assert g.ledger["dht_overflows"] == 0, entry
                assert g.shuffles == w.shuffles, entry


# -------------------------------- (f) overflows reach every graph's ledger
def test_lookup_many_surfaces_overflows_on_every_ledger():
    """tests/test_solve_many.py's case on the port: per-graph queries split
    by the mask, and a capacity-starved exchange's overflows on every
    ledger, readable at once (bare ledgers are eager)."""
    vals = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    keys = torch.arange(8, dtype=torch.int32).repeat(2, 1)
    mask = np.ones((2, 8), bool)
    mask[0, 5:] = False
    leds = [RoundLedger("a"), RoundLedger("b")]
    out = RoutedDht().lookup_many(vals, keys, ledgers=leds, key_mask=mask)
    np.testing.assert_array_equal(out[1].numpy(), np.arange(8, 16))
    np.testing.assert_array_equal(out[0, :5].numpy(), np.arange(5))
    assert [led.dht_queries for led in leds] == [5, 8]
    assert all(led.dht_overflows == 0 for led in leds)
    # the bucket's one exchange: graph b's key k is b * 8 + k
    flat_keys = np.where(mask, keys.numpy() + [[0], [8]], -1).reshape(-1)
    for P in (1, 8):
        want = _model(vals.numpy().reshape(-1), flat_keys, P, 1, False)[2]
        assert want > 0
        leds = [RoundLedger("a"), RoundLedger("b")]
        RoutedDht(tdht.make_mesh(P), capacity=1).lookup_many(
            vals, keys, ledgers=leds, key_mask=mask)
        assert [led.dht_overflows for led in leds] == [want, want]
    # deferred ledgers get the same count at their harvest
    leds = [RoundLedger("a", deferred=True), RoundLedger("b", deferred=True)]
    RoutedDht(capacity=1).lookup_many(vals, keys, ledgers=leds,
                                      key_mask=mask)
    assert all(led.dht_overflows == 0 for led in leds)
    from repro_torch.core.rounds import harvest_many
    harvest_many(leds)
    assert [led.dht_overflows for led in leds] == [12, 12]
