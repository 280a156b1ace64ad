"""The DHT over a process group and ``compressed_psum``: the port's router
with one rank a shard (``routed_lookup``, ``ShardedDHT``, ``RoutedDht`` and
``AmpcEngine`` on a ``DeviceMesh``) in 1, 2 and 4 ``gloo`` processes,
against the JAX package's router and ``compressed_psum`` on 4 host devices
and against the port's one-process router and engine.

Tolerance 0 throughout: the router is integer bookkeeping, and the
compression is integer sums of the reference's own quantization.

  (a) ``routed_lookup`` at 4 ranks (each rank its block and its run)
      against the reference's ``routed_lookup`` on 4 host devices: dedup
      on and off, capacities 1, 2 and the run's length, 1-D and (n, 3)
      values, -1 keys, Q a multiple of 4; outputs, distinct counts and
      overflows;
  (b) ``ShardedDHT(mesh=DeviceMesh)`` at 1, 2 and 4 ranks against the
      one-process router at the same shard count, with rows and keys that
      are not multiples of it, on every dtype the solvers send, and along
      one dimension of a (2, 2) mesh: outputs and every ledger counter;
  (c) every registered problem through ``solve`` at 1, 2 and 4 ranks:
      outputs, stats and every ``summary()`` counter but the walls equal
      to the one-process routed engine at the same shard count; and the
      reference's 4-device engine's ``mis`` (output and every counter);
  (d) at 2 ranks ``solve_many``, a session (cold, then warm) and 8
      ``submit``s on 2 workers equal to the local backend; a
      capacity-starved ``lookup_many`` records its overflows on every
      ledger of every rank; ``serialize_launches=False`` on a group
      backend raises; ``RoutedDht()`` takes the world;
  (e) ``compressed_psum`` at 1 rank equal to ``decompress_tree`` of
      ``compress_tree``, at 2 and 4 ranks and along one dimension of a
      (2, 2) mesh against the reference's under ``shard_map``, on
      mixtral's smoke gradients and hand-made leaves with ``.5`` ties and
      one rank whose maximum sets the shared scale: the average and the
      feedback bit-equal on every rank;
  (f) in every engine run, every rank looked up the same keys (each
      lookup all-gathers a hash of its keys, here in the test).

The reference's ``compressed_psum`` is compiled without XLA's algebraic
simplifier and fusion, so each of its operations rounds as its code
writes it (as its eager calls do, which ``tests/test_torch_runtime.py``
holds ``compress`` to): jitted whole, XLA divides by 127.0 as a product
with the reciprocal and contracts ``g + fb - q * s`` into a fused
multiply-add, one bit off on some elements.

The worlds run their ranks in spawned processes with a join timeout, so a
hang fails the tests with the stacks the ranks dumped.  Each rank writes
what it found to a file; the tests hold the files against the one-process
port (here) and the reference (one JAX subprocess started beside the
worlds; it calls the reference's functions under ``jax.jit``, because its
bare ``shard_map`` takes some 6 s a call on the CPU).
"""
import contextlib
import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time
import zlib

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.ampc import AmpcEngine, RoutedDht, registry
from repro_torch.ampc.engine import _field_eq
from repro_torch.configs import registry as model_registry
from repro_torch.core import dht as tdht
from repro_torch.core.rounds import RoundLedger, harvest_many
from repro_torch.graph import generators as gen
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim import grad_compression as gc

JOIN_TIMEOUT_S = 300
WORLDS = (1, 2, 4)

# (a): (name, n, q, wide, dedup, capacity); n and q multiples of 4, as the
# reference's router asks
REFERENCE_CASES = [
    (f"{'n3' if wide else '1d'}_{'dedup' if dedup else 'nodedup'}_cap"
     f"{cap or 'q'}", 40, 64, wide, dedup, cap)
    for wide in (False, True) for dedup in (True, False)
    for cap in (1, 2, None)]

# (b): every dtype the solvers send (status and masks int8/int32, labels
# int32/int64, bool, float32 ranks and weights) and those gloo carries
DTYPES = {"bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
          "int32": torch.int32, "int64": torch.int64,
          "float32": torch.float32, "bfloat16": torch.bfloat16}
# (name, dtype, wide, dedup, capacity): 29 rows and 45 keys, multiples of
# neither 2 nor 4
RAGGED_CASES = (
    [(f"{d}_{'dedup' if dedup else 'nodedup'}", d, False, dedup, None)
     for d in DTYPES for dedup in (True, False)]
    + [("int32_n3_cap1", "int32", True, True, 1),
       ("float32_n3_cap2_nodedup", "float32", True, False, 2)])

SERVING_FLEET = (50, 60, 100, 120)


# ------------------------------------------------------------------ inputs
def _values(n, wide, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-1000, 1000, (n, 3) if wide else (n,)) \
        .astype(np.int32)


def _keys(n, q, seed):
    """Keys in [-1, n): padding, duplicates, every owner."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-1, n, q).astype(np.int32)
    keys[: q // 4] = keys[q // 4: 2 * (q // 4)]
    return keys


def _reference_input(name):
    case = next(c for c in REFERENCE_CASES if c[0] == name)
    seed = sum(map(ord, name))
    return _values(case[1], case[3], seed), _keys(case[1], case[2], seed + 1)


def _ragged_input(name):
    """(values tensor, keys tensor, dedup, capacity) of a (b) case."""
    _, dtype, wide, dedup, cap = next(c for c in RAGGED_CASES
                                      if c[0] == name)
    seed = sum(map(ord, name))
    raw = torch.from_numpy(_values(29, wide, seed))
    if dtype == "bool":
        values = raw > 0
    elif dtype in ("float32", "bfloat16"):
        values = (raw.float() / 7).to(DTYPES[dtype])
    else:
        values = (raw % 100).to(DTYPES[dtype])
    return values, torch.from_numpy(_keys(29, 45, seed + 1)), dedup, cap


def _graph(problem):
    spec = registry.get(problem)
    if spec.needs_cycles:
        return gen.two_cycles(30)
    g = gen.erdos_renyi(60, 3.0, seed=2)
    return g.with_random_weights(3) if spec.needs_weights else g


def _opts(problem):
    return {"p": 1 / 8} if problem == "one-vs-two" else {}


def _serving_fleet():
    return [gen.erdos_renyi(n, 4.0, seed=n) for n in SERVING_FLEET]


def _starved_read():
    """tests/test_torch_routed.py's lookup_many case: two graphs of 8
    rows, graph 0's last three keys masked."""
    vals = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    keys = torch.arange(8, dtype=torch.int32).repeat(2, 1)
    mask = np.ones((2, 8), bool)
    mask[0, 5:] = False
    return vals, keys, mask


def _gradient_trees():
    """Four ranks' gradient trees and feedback: mixtral's smoke LM (f32)
    on four seeded batches, plus hand-made leaves.  ``ties``: rank 1's
    largest |value| (254) sets the shared scale 2, against which ranks 0
    and 2's odd integers fall on .5 ties; ``fb_ties`` reaches the same
    ties through a nonzero feedback."""
    cfg = dataclasses.replace(
        model_registry.get("mixtral-8x22b").smoke_config,
        dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu")
    named = dict(model.named_parameters())
    ties = [[5, -3, 1, 7, 127, -9, 11, 0], [254, 3, -5, 9, 1, -1, 0, 2],
            [63, 1, -1, 3, 5, -7, 13, 15], [25, -25, 3, 1, 0, -3, 5, 7]]
    trees = []
    for r in range(4):
        rng = np.random.default_rng(r)
        tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
        model.zero_grad(set_to_none=True)
        model.loss_fn(tokens, labels)[0].backward()
        grads = {n: (p.grad if p.grad is not None
                     else torch.zeros_like(p)).detach().clone()
                 for n, p in named.items()}
        fb = gc.init_feedback(grads)
        grads["ties"] = torch.tensor(ties[r], dtype=torch.float32)
        fb["ties"] = torch.zeros(8)
        grads["fb_ties"] = grads["ties"] - 0.5
        fb["fb_ties"] = torch.full((8,), 0.5)
        trees.append((grads, fb))
    return trees


# ----------------------------------------------------- the reference's side
REFERENCE_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, pickle, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.ampc import AmpcEngine
    from repro.core import dht
    from repro.graph import generators as gen
    from repro.optim import grad_compression as jgc

    assert len(jax.devices()) == 4
    out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
    data = np.load(os.path.join(out_dir, "lookups.npz"))
    dht.routed_lookup = jax.jit(dht.routed_lookup,
                                static_argnums=(2, 3, 4, 5))
    mesh = jax.make_mesh((4,), ("dht",))
    res = {"a": {}}
    for name, dedup, cap in cases:
        out, nu, ov = dht.routed_lookup(
            jnp.asarray(data[name + "_values"]),
            jnp.asarray(data[name + "_keys"]), mesh, "dht", cap, dedup)
        res["a"][name] = (np.asarray(out), int(nu), int(ov))
    g = gen.erdos_renyi(60, 3.0, seed=2)
    r = AmpcEngine(mesh=mesh, dht_backend="routed", seed=0).solve(g, "mis")
    ledger = {k: v for k, v in r.ledger.items()
              if k not in ("wall_time_s", "phase_times")}
    ledger["phases"] = list(r.ledger["phase_times"])
    res["mis"] = {"edges": np.asarray(g.edges),
                  "output": np.asarray(r.output), "ledger": ledger,
                  "stats": json.loads(json.dumps(r.stats))}
    with open(os.path.join(out_dir, "trees.pkl"), "rb") as f:
        trees = pickle.load(f)

    def body(g, fb):
        g, fb = jax.tree.map(lambda x: x[0], (g, fb))
        avg, fb2 = jgc.compressed_psum(g, fb, "data")
        return jax.tree.map(lambda x: x[None], (avg, fb2))

    def psum_on(ranks):
        m = Mesh(np.array(jax.devices()[:len(ranks)]), ("data",))
        g, fb = ({k: np.stack([trees[r][i][k] for r in ranks])
                  for k in trees[0][i]} for i in (0, 1))
        # each operation rounded as the code writes it, as its eager calls
        # run: without XLA's algebraic simplifier (it turns the division by
        # 127.0 into a product with the reciprocal) and fusion (a fused
        # g + fb - q * s contracts into a fused multiply-add)
        f = jax.jit(shard_map(body, mesh=m, in_specs=(P("data"), P("data")),
                              out_specs=(P("data"), P("data")),
                              check_rep=False),
                    compiler_options={"xla_disable_hlo_passes":
                                      "algsimp,fusion"})
        return jax.tree.map(np.asarray, f(g, fb))

    res["e"] = {key: psum_on(ranks) for key, ranks in (
        ("4", [0, 1, 2, 3]), ("2", [0, 1]), ("data_0", [0, 2]),
        ("data_1", [1, 3]))}
    with open(os.path.join(out_dir, "reference.pkl"), "wb") as f:
        pickle.dump(res, f)
    print("REFERENCE_OK")
""")


def _start_reference(out_dir, trees):
    inputs = {}
    for name, *_ in REFERENCE_CASES:
        values, keys = _reference_input(name)
        inputs.update({name + "_values": values, name + "_keys": keys})
    np.savez(os.path.join(out_dir, "lookups.npz"), **inputs)
    with open(os.path.join(out_dir, "trees.pkl"), "wb") as f:
        pickle.dump([tuple({k: v.numpy() for k, v in t.items()}
                           for t in tree) for tree in trees], f)
    cases = [(name, dedup, cap) for name, _, _, _, dedup, cap
             in REFERENCE_CASES]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE_SCRIPT, out_dir, json.dumps(cases)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


# ------------------------------------------------------------- the ranks
def _counters(led):
    """A ledger summary's counters: its walls left out, its phases kept
    by name."""
    led = dict(led)
    led.pop("wall_time_s")
    led["phase_times"] = list(led["phase_times"])
    return led


def _result(r):
    stats = {k: v for k, v in r.stats.items() if k != "async"}
    if "snapshot" in stats:
        stats["snapshot"] = {k: v for k, v in stats["snapshot"].items()
                             if k != "key"}
    return {"backend": r.backend, "output": r.output, "stats": stats,
            "ledger": _counters(r.ledger)}


@contextlib.contextmanager
def _key_hashes(record):
    """Every group lookup all-gathers (its key count, a CRC of its keys)
    over the router's group and records whether every rank's pair is its
    own."""
    import torch.distributed as dist
    real = tdht.ShardedDHT.lookup
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor

    def lookup(self, keys, dedup=True):
        if self._group is not None:
            group, P, _ = self._group
            k = torch.as_tensor(keys).to(torch.int32).reshape(-1)
            mine = torch.tensor([k.numel(),
                                 zlib.crc32(k.contiguous().numpy())],
                                dtype=torch.int64)
            every = torch.empty(2 * P, dtype=torch.int64)
            gather(every, mine, group=group)
            record.append(bool((every.reshape(P, 2) == mine).all()))
        return real(self, keys, dedup)

    tdht.ShardedDHT.lookup = lookup
    try:
        yield
    finally:
        tdht.ShardedDHT.lookup = real


def _lookups(mesh, world):
    """(a) at 4 ranks: each rank's run; (b) the whole answer and the
    ledger's counters."""
    rank = torch.distributed.get_rank()
    out = {"a": {}, "b": {}}
    if world == 4:
        for name, n, q, _, dedup, cap in REFERENCE_CASES:
            values, keys = map(torch.from_numpy, _reference_input(name))
            size, run = n // world, q // world
            got, nu, ov = tdht.routed_lookup(
                values[rank * size:(rank + 1) * size],
                keys[rank * run:(rank + 1) * run], mesh, "dht",
                capacity=cap, dedup=dedup)
            out["a"][name] = (got.numpy(), int(nu), int(ov))
    for name, *_ in RAGGED_CASES:
        values, keys, dedup, cap = _ragged_input(name)
        led = RoundLedger(name)
        got = tdht.ShardedDHT(values, ledger=led, mesh=mesh,
                              capacity=cap).lookup(keys, dedup=dedup)
        out["b"][name] = (got, _counters(led.summary()))
    return out


def _engine_runs(mesh):
    """(c) every problem's solve on the group backend; (f) its lookups'
    key agreement."""
    out, hashes = {}, {}
    eng = AmpcEngine(mesh=mesh, dht_backend="routed", seed=0, device="cpu",
                     metrics=False)
    for problem in registry.names():
        record = []
        with _key_hashes(record):
            out[problem] = _result(eng.solve(_graph(problem), problem,
                                             **_opts(problem)))
        hashes[f"solve:{problem}"] = record
    return out, hashes


def _serving_runs(mesh):
    """(d) at 2 ranks."""
    out, hashes = {}, {}
    fleet = _serving_fleet()
    with AmpcEngine(mesh=mesh, dht_backend="routed", seed=0, device="cpu",
                    metrics=False, max_workers=2) as eng:
        for problem in ("mis", "connectivity"):
            record = []
            with _key_hashes(record):
                out[f"solve_many:{problem}"] = [
                    _result(r) for r in eng.solve_many(fleet, problem)]
            hashes[f"solve_many:{problem}"] = record
        record = []
        with _key_hashes(record):
            sess = eng.session(fleet[0])
            out["session"] = [_result(sess.solve("connectivity"))
                              for _ in range(2)]
        hashes["session"] = record
        record = []
        with _key_hashes(record):
            futures = [eng.submit(g, p) for g, p in zip(
                fleet * 2, ["mis", "connectivity"] * 4)]
            out["submit"] = [_result(f.result(timeout=120))
                             for f in futures]
        hashes["submit"] = record
    vals, keys, mask = _starved_read()
    eager = [RoundLedger("a"), RoundLedger("b")]
    backend = RoutedDht(mesh, capacity=1)
    out["starved_out"] = backend.lookup_many(vals, keys, ledgers=eager,
                                             key_mask=mask)
    deferred = [RoundLedger("a", deferred=True),
                RoundLedger("b", deferred=True)]
    backend.lookup_many(vals, keys, ledgers=deferred, key_mask=mask)
    before = [led.dht_overflows for led in deferred]
    harvest_many(deferred)
    out["starved"] = {"eager": [_counters(led.summary()) for led in eager],
                      "deferred_before": before,
                      "deferred": [_counters(led.summary())
                                   for led in deferred]}
    try:
        AmpcEngine(mesh=mesh, dht_backend="routed", device="cpu",
                   serialize_launches=False)
    except ValueError as e:
        out["unserialized"] = str(e)
    default = AmpcEngine(dht_backend="routed", device="cpu", metrics=False)
    out["default_repr"] = repr(default.dht)
    out["default_connectivity"] = _result(default.solve(fleet[1],
                                                        "connectivity"))
    return out, hashes


def _psum_runs(mesh, world, out_dir):
    """(e): compressed_psum on the mesh and on the default group; at 4
    ranks also along the "data" dimension of a (2, 2) mesh, and the
    router along its "model" dimension."""
    from torch.distributed.device_mesh import init_device_mesh
    rank = torch.distributed.get_rank()
    with open(os.path.join(out_dir, "trees.pt"), "rb") as f:
        grads, fb = torch.load(f)[rank]
    out = {"mesh": gc.compressed_psum(grads, fb, "dht", mesh=mesh),
           "default": gc.compressed_psum(grads, fb, "data")}
    if world == 4:
        grid = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out["data"] = gc.compressed_psum(grads, fb, "data", mesh=grid)
        values, keys, dedup, cap = _ragged_input("int32_n3_cap1")
        led = RoundLedger("int32_n3_cap1")
        got = tdht.ShardedDHT(values, ledger=led, mesh=grid,
                              axis_name="model", capacity=cap).lookup(
                                  keys, dedup=dedup)
        out["model_axis"] = (got, _counters(led.summary()))
    return out


def _worker(rank, world, port, out_dir):
    import faulthandler
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # one thread a rank: the suite runs beside other test processes, and
    # spinning intra-op threads over more ranks than cores stall gloo
    torch.set_num_threads(1)
    # where a rank stands if it outlives the parent's patience
    stacks = open(os.path.join(out_dir, f"stacks-{world}-{rank}.txt"), "w")
    faulthandler.dump_traceback_later(JOIN_TIMEOUT_S - 20, file=stacks)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("dht",))
        res = _lookups(mesh, world)
        res["c"], res["f"] = _engine_runs(mesh)
        if world == 2:
            res["d"], hashes = _serving_runs(mesh)
            res["f"].update(hashes)
        res["e"] = _psum_runs(mesh, world, out_dir)
        with open(os.path.join(out_dir, f"rank-{world}-{rank}.pkl"),
                  "wb") as f:
            pickle.dump(res, f)
    finally:
        faulthandler.cancel_dump_traceback_later()
        stacks.close()
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(worlds, out_dir):
    """Run ``_worker`` in a world of each size at once; fail (and stop
    them) past ``JOIN_TIMEOUT_S``, with the stacks the ranks dumped."""
    ctxs = [mp.start_processes(_worker, args=(w, _free_port(), out_dir),
                               nprocs=w, join=False, start_method="spawn")
            for w in worlds]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for world, ctx in zip(worlds, ctxs):
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for c in ctxs:
                    for p in c.processes:
                        p.kill()
                    for p in c.processes:
                        p.join(10)
                stacks = "".join(
                    open(os.path.join(out_dir, f)).read()
                    for f in sorted(os.listdir(out_dir))
                    if f.startswith("stacks-"))
                pytest.fail(f"the {world}-rank world hung past "
                            f"{JOIN_TIMEOUT_S} s:\n{stacks}")
        assert all(not p.is_alive() for p in ctx.processes)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dht_group"))
    trees = _gradient_trees()
    with open(os.path.join(out, "trees.pt"), "wb") as f:
        torch.save(trees, f)
    reference = _start_reference(out, trees)
    try:
        _spawn(WORLDS, out)
        stdout, stderr = reference.communicate(timeout=JOIN_TIMEOUT_S)
    finally:
        if reference.poll() is None:
            reference.kill()
            reference.communicate()
    assert reference.returncode == 0 and "REFERENCE_OK" in stdout, \
        stderr[-3000:]
    ranks = {}
    for w in WORLDS:
        ranks[w] = []
        for r in range(w):
            with open(os.path.join(out, f"rank-{w}-{r}.pkl"), "rb") as f:
                ranks[w].append(pickle.load(f))
    with open(os.path.join(out, "reference.pkl"), "rb") as f:
        ref = pickle.load(f)
    return {"ranks": ranks, "ref": ref, "trees": trees}


# ------------------------------------------- (a) 4 ranks vs the reference
@pytest.mark.parametrize("name", [c[0] for c in REFERENCE_CASES])
def test_group_router_matches_the_reference_at_four_ranks(runs, name):
    want_out, want_nu, want_ov = runs["ref"]["a"][name]
    per_rank = [r["a"][name] for r in runs["ranks"][4]]
    np.testing.assert_array_equal(
        np.concatenate([out for out, _, _ in per_rank]), want_out)
    assert all((nu, ov) == (want_nu, want_ov) for _, nu, ov in per_rank)
    if "capq" in name:
        assert want_ov == 0


# ------------------------------ (b) against the one-process router at P
def _one_process(name, P, mesh=None, axis_name="dht"):
    values, keys, dedup, cap = _ragged_input(name)
    led = RoundLedger(name)
    out = tdht.ShardedDHT(values, ledger=led,
                          mesh=mesh or tdht.make_mesh(P),
                          axis_name=axis_name, capacity=cap).lookup(
                              keys, dedup=dedup)
    return out, _counters(led.summary())


@pytest.mark.parametrize("name", [c[0] for c in RAGGED_CASES])
@pytest.mark.parametrize("world", WORLDS)
def test_group_dht_equals_the_one_process_router(runs, world, name):
    want, want_counts = _one_process(name, world)
    for rank, res in enumerate(runs["ranks"][world]):
        got, counts = res["b"][name]
        assert got.dtype == want.dtype and torch.equal(got, want), rank
        assert counts == want_counts, (rank, counts, want_counts)
    if "cap" not in name:
        assert want_counts["dht_overflows"] == 0


def test_group_dht_along_one_dimension_of_a_grid(runs):
    """At 4 ranks on a (2, 2) ("data", "model") mesh, the router along
    "model" (two groups of 2 ranks) equals the one-process router at 2."""
    want, want_counts = _one_process("int32_n3_cap1", 2)
    assert want_counts["dht_overflows"] > 0
    for res in runs["ranks"][4]:
        got, counts = res["e"]["model_axis"]
        assert torch.equal(got, want) and counts == want_counts


# ------------------------------------------------ (c) every problem's solve
def _same(got, want):
    assert got["backend"] == want["backend"] == "routed"
    np.testing.assert_array_equal(got["output"], want["output"])
    assert _field_eq(got["stats"], want["stats"]), (got["stats"],
                                                    want["stats"])
    assert got["ledger"] == want["ledger"], (got["ledger"], want["ledger"])


@pytest.mark.parametrize("problem", registry.names())
@pytest.mark.parametrize("world", WORLDS)
def test_group_engine_equals_the_one_process_engine(runs, world, problem):
    eng = AmpcEngine(mesh=tdht.make_mesh(world), dht_backend="routed",
                     seed=0, device="cpu", metrics=False)
    want = _result(eng.solve(_graph(problem), problem, **_opts(problem)))
    assert want["ledger"]["dht_overflows"] == 0
    for res in runs["ranks"][world]:
        _same(res["c"][problem], want)


def test_group_engine_mis_matches_the_reference_at_four_devices(runs):
    ref = runs["ref"]["mis"]
    np.testing.assert_array_equal(_graph("mis").edges, ref["edges"])
    for res in runs["ranks"][4]:
        got = res["c"]["mis"]
        np.testing.assert_array_equal(got["output"], ref["output"])
        ledger = {k: v for k, v in got["ledger"].items()
                  if k != "phase_times"}
        ledger["phases"] = got["ledger"]["phase_times"]
        assert ledger == ref["ledger"]
        assert ledger["dht_overflows"] == 0 and ledger["shuffles"] == 2
        assert _field_eq(json.loads(json.dumps(got["stats"])), ref["stats"])


# ------------------------------------------------------- (d) serving
def _local_results(problem, graphs, many=False):
    eng = AmpcEngine(seed=0, device="cpu", metrics=False)
    if many:
        return eng.solve_many(graphs, problem)
    return [eng.solve(g, problem) for g in graphs]


def _same_answer(got, want):
    np.testing.assert_array_equal(got["output"], want.output)
    assert got["ledger"]["dht_overflows"] == 0
    assert got["ledger"]["shuffles"] == want.shuffles


@pytest.mark.parametrize("problem", ["mis", "connectivity"])
def test_group_solve_many_equals_local(runs, problem):
    want = _local_results(problem, _serving_fleet(), many=True)
    for res in runs["ranks"][2]:
        many = res["d"][f"solve_many:{problem}"]
        assert len(many) == len(want)
        for got, w in zip(many, want):
            _same_answer(got, w)
            # the solver cache tells the group's meshes apart
            key = got["stats"]["solver_cache"]["key"]
            assert key[:2] == (problem, "routed")
            assert key[-1] == ("group", "cpu", "dht", (0, 1))


def test_group_session_cold_then_warm_equals_local(runs):
    want = _local_results("connectivity", _serving_fleet()[:1])[0]
    for res in runs["ranks"][2]:
        cold, warm = res["d"]["session"]
        for got, hit, shuffles in ((cold, False, 2), (warm, True, 1)):
            np.testing.assert_array_equal(got["output"], want.output)
            assert got["stats"]["snapshot"]["hit"] is hit
            assert got["ledger"]["shuffles"] == shuffles


def test_group_submits_on_two_workers_equal_local(runs):
    fleet = _serving_fleet()
    want = [_local_results(p, [g])[0] for g, p in zip(
        fleet * 2, ["mis", "connectivity"] * 4)]
    for res in runs["ranks"][2]:
        assert len(res["d"]["submit"]) == 8
        for got, w in zip(res["d"]["submit"], want):
            _same_answer(got, w)


def test_group_lookup_many_overflows_reach_every_ledger(runs):
    vals, keys, mask = _starved_read()
    eager = [RoundLedger("a"), RoundLedger("b")]
    backend = RoutedDht(tdht.make_mesh(2), capacity=1)
    want_out = backend.lookup_many(vals, keys, ledgers=eager, key_mask=mask)
    want = [_counters(led.summary()) for led in eager]
    assert all(c["dht_overflows"] > 0 for c in want)
    for res in runs["ranks"][2]:
        starved = res["d"]["starved"]
        assert torch.equal(res["d"]["starved_out"], want_out)
        assert starved["eager"] == want
        assert starved["deferred_before"] == [0, 0]
        assert starved["deferred"] == want


def test_group_backend_refusals_and_default_mesh(runs):
    """``serialize_launches=False`` on a group backend raises; without a
    mesh under a process group ``RoutedDht`` spans the world; without a
    process group there is no group to take."""
    want = _local_results("connectivity", _serving_fleet()[1:2])[0]
    for res in runs["ranks"][2]:
        assert "process group" in res["d"]["unserialized"]
        assert res["d"]["default_repr"] == \
            "RoutedDht(axis='dht', ranks=[0, 1], device='cpu')"
        _same_answer(res["d"]["default_connectivity"], want)
    assert RoutedDht().mesh is None
    with pytest.raises(RuntimeError, match="not initialized"):
        gc.compressed_psum({"w": torch.ones(2)}, {"w": torch.zeros(2)})


# ------------------------------------------------- (e) compressed_psum
def _bits_equal(got, want, rank, what):
    assert set(got) == set(want), what
    for k in want:
        w = torch.as_tensor(np.asarray(want[k]))
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, (k, what)
        assert got[k].numpy().tobytes() == w.numpy().tobytes(), \
            (rank, what, k)


def test_compressed_psum_at_one_rank_is_decompress_of_compress(runs):
    grads, fb = runs["trees"][0]
    q, s, want_fb = gc.compress_tree(grads, fb)
    want_avg = gc.decompress_tree(q, s)
    for key in ("mesh", "default"):
        avg, new_fb = runs["ranks"][1][0]["e"][key]
        _bits_equal(avg, {k: v.numpy() for k, v in want_avg.items()}, 0,
                    f"{key} avg")
        _bits_equal(new_fb, {k: v.numpy() for k, v in want_fb.items()}, 0,
                    f"{key} feedback")


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_matches_the_reference(runs, world):
    ref_avg, ref_fb = runs["ref"]["e"][str(world)]
    assert float(ref_avg["ties"][0].max()) > 0
    for rank, res in enumerate(runs["ranks"][world]):
        for key in ("mesh", "default"):
            avg, fb = res["e"][key]
            _bits_equal(avg, {k: v[rank] for k, v in ref_avg.items()},
                        rank, f"{key} avg")
            _bits_equal(fb, {k: v[rank] for k, v in ref_fb.items()}, rank,
                        f"{key} feedback")
    # rank 1 sets the shared scale 2 of the tie leaves: rank 0's 5 and 7
    # land on 2.5 and 3.5 and round to even
    _, fb0 = runs["ranks"][world][0]["e"]["mesh"]
    assert fb0["ties"][:4].tolist() == [1.0, 1.0, 1.0, -1.0]


def test_compressed_psum_along_one_dimension_of_a_grid(runs):
    """At 4 ranks on a (2, 2) mesh, along "data": ranks 0 and 2, 1 and 3
    each average their pair, as the reference's on 2 devices."""
    for rank, res in enumerate(runs["ranks"][4]):
        model, row = rank % 2, rank // 2
        ref_avg, ref_fb = runs["ref"]["e"][f"data_{model}"]
        avg, fb = res["e"]["data"]
        _bits_equal(avg, {k: v[row] for k, v in ref_avg.items()}, rank,
                    "avg")
        _bits_equal(fb, {k: v[row] for k, v in ref_fb.items()}, rank,
                    "feedback")


# ------------------------------------------- (f) every rank's keys agree
# the problems whose solve reads the DHT (the MPC baselines, the cycle
# problems and the multi-launch variants read none)
DHT_READERS = ("connectivity", "matching", "mis", "msf", "vertex-cover",
               "weighted-matching")


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_looks_up_the_same_keys(runs, world):
    for res in runs["ranks"][world]:
        assert set(res["f"]) >= {f"solve:{p}" for p in registry.names()}
        for run, record in res["f"].items():
            assert all(record), f"{run}: the ranks' keys differ"
            reads = not run.startswith("solve:") or \
                run[len("solve:"):] in DHT_READERS
            assert bool(record) == reads, (run, len(record))
