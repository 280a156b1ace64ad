"""Port DHT and ``dht_gather`` against the JAX package (tolerance 0).

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs ``ShardedDHT(impl="take")`` and ``dht_gather(impl="ref")``;
the Pallas interpret path does not run under the installed JAX.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import dht as jdht
from repro.core.rounds import RoundLedger as JLedger
from repro.kernels.dht_gather.ops import dht_gather as jax_dht_gather

from repro_torch.core import dht as tdht
from repro_torch.core import rounds
from repro_torch.core.rounds import RoundLedger as TLedger
from repro_torch.kernels.dht_gather import kernel, ops
from repro_torch.kernels.dht_gather.ref import (dht_gather_fused_ref,
                                                dht_gather_ref)


def _keys(kind: str, V: int, Q: int, seed: int = 0) -> np.ndarray:
    """Key batches covering the cases the kernel must get right."""
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return np.zeros(0, np.int32)
    if kind == "one":
        return np.array([V + 2], np.int32)
    if kind == "all_padding":
        return np.full(Q, -1, np.int32)
    if kind == "unsorted":
        return rng.integers(0, V, size=Q).astype(np.int32)
    if kind == "padding_and_oob":
        k = rng.integers(-3, V + 5, size=Q).astype(np.int32)
        k[::7] = -1
        return k
    if kind == "block_edge_runs":
        # sorted duplicate runs straddling every 64-key block boundary
        k = np.sort(rng.integers(0, max(V // 8, 1), size=Q)).astype(np.int32)
        for edge in range(64, Q, 64):
            k[edge - 2:edge + 2] = k[edge - 2]
        return rng.permutation(k)
    raise ValueError(kind)


KINDS = ["empty", "unsorted", "padding_and_oob", "block_edge_runs"]
TABLES = [(1, np.int32), (16, np.float32), (1, np.float32), (16, np.int32)]


def _table(V, D, dtype, seed=1):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-1000, 1000, size=(V, D)).astype(np.int32)
    return rng.standard_normal((V, D)).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("D,dtype", TABLES)
def test_dht_gather_plain_matches_jax_ref(kind, D, dtype):
    V, Q = 300, 1000
    table = _table(V, D, dtype)
    keys = _keys(kind, V, Q)
    j_out, j_hits = jax_dht_gather(jnp.asarray(table), jnp.asarray(keys),
                                   impl="ref")
    t_out, t_hits = ops.dht_gather(torch.from_numpy(table),
                                   torch.from_numpy(keys))
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    assert int(t_hits) == int(j_hits)
    valid = keys[keys >= 0]
    assert int(t_hits) == valid.size - np.unique(valid).size


@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("kind", KINDS + ["one", "all_padding"])
@pytest.mark.parametrize("D,dtype", TABLES)
def test_fused_mirror_matches_jax_ref(kind, D, dtype, presorted):
    """The kernel's contract in plain torch (sorted keys and the sort's
    order in, rows out in the caller's order) against the JAX package's
    whole ``dht_gather(impl="ref")``, bit for bit, hits exact."""
    V, Q = 300, 1000
    table = _table(V, D, dtype)
    keys = _keys(kind, V, Q)
    if presorted:
        keys = np.sort(keys)
    j_out, j_hits = jax_dht_gather(jnp.asarray(table), jnp.asarray(keys),
                                   impl="ref", presorted=presorted)
    tkeys = torch.from_numpy(keys)
    if presorted:
        sk, order = tkeys, None
    else:
        sk, order = torch.sort(tkeys, stable=True)
    t_out, t_hits = dht_gather_fused_ref(torch.from_numpy(table), sk, order)
    assert t_out.shape == (keys.size, D)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    assert int(t_hits) == int(j_hits)


@pytest.mark.parametrize("row_bytes,addresses,width", [
    (200, (0, 256), 8),          # D 50 f32: 25 chunks of 8 bytes
    (256, (0, 512), 16),         # D 64 f32, D 128 bf16
    (4, (0, 1024), 4),           # D 1 int32
    (8, (0, 0), 8),              # D 2 f32
    (12, (0, 0), 4),             # D 3 f32
    (6, (0, 0), 2),              # D 3 bf16
    (200, (200, 0), 8),          # from row 1 of a D 50 f32 table
    (256, (4, 0), 4),            # a D 64 f32 view from element 1
    (256, (0, 8), 8),            # the output's address decides too
    (128, (2, 0), 2),            # a bf16 view from element 1
])
def test_chunk_width_divides_the_row_and_every_address(row_bytes, addresses,
                                                      width):
    assert kernel.chunk_bytes(row_bytes, *addresses) == width


def test_chunk_width_refuses_an_odd_row():
    with pytest.raises(ValueError, match="no chunk width"):
        kernel.chunk_bytes(3, 0, 0)


def test_dht_gather_presorted_and_plain_version_agree():
    V, Q = 200, 640
    table = torch.from_numpy(_table(V, 4, np.float32))
    keys = torch.from_numpy(np.sort(_keys("padding_and_oob", V, Q)))
    out, hits = ops.dht_gather(table, keys, presorted=True)
    ref_out, ref_hits = dht_gather_ref(table, keys)
    assert torch.equal(out, ref_out) and int(hits) == int(ref_hits)


def test_dht_gather_rejects_what_the_kernel_does_not_take():
    table = torch.zeros(8, 2)
    with pytest.raises(ValueError):
        ops.dht_gather(table, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        ops.dht_gather(table[0], torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernel.dht_gather_cuda(table, torch.zeros(3, dtype=torch.int32))


def test_cpu_tensors_never_launch_the_kernel():
    before = ops.dht_gather.launches
    ops.dht_gather(torch.zeros(8, 1, dtype=torch.int32),
                   torch.arange(8, dtype=torch.int32))
    assert ops.dht_gather.launches == before


@pytest.mark.parametrize("kind", KINDS)
def test_dedup_keys_matches_jax(kind):
    keys = _keys(kind, 500, 700, seed=3)
    ju, ji, jn = jdht.dedup_keys(jnp.asarray(keys))
    tu, ti, tn = tdht.dedup_keys(torch.from_numpy(keys))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tn) == int(jn)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("kind", ["unsorted", "padding_and_oob",
                                  "block_edge_runs"])
def test_lookup_matches_jax(kind, dedup):
    values = _table(400, 3, np.float32, seed=4)
    keys = _keys(kind, 400, 900, seed=5)
    j_out, j_n = jdht.lookup(jnp.asarray(values), jnp.asarray(keys),
                             dedup=dedup)
    t_out, t_n = tdht.lookup(torch.from_numpy(values),
                             torch.from_numpy(keys), dedup=dedup)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    assert int(t_n) == int(j_n)


def _counters(ledger):
    return ledger.dht_queries, ledger.dht_bytes, ledger.dedup_savings


@pytest.mark.parametrize("impl", ["take", "cuda"])
@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape,dtype", [((600,), np.int32),
                                         ((600, 16), np.float32)])
def test_sharded_dht_matches_jax_take(shape, dtype, kind, dedup, impl):
    """Rows and ledger counters of the port's ShardedDHT (``impl="cuda"``
    takes the plain version on CPU tensors) equal the JAX take path."""
    values = _table(shape[0], 1 if len(shape) == 1 else shape[1], dtype)
    values = values.reshape(shape)
    keys = _keys(kind, shape[0], 1000, seed=6)
    jl, tl = JLedger("j", deferred=True), TLedger("t")
    j_out = jdht.ShardedDHT(jnp.asarray(values), ledger=jl,
                            impl="take").lookup(jnp.asarray(keys), dedup)
    t_dht = tdht.ShardedDHT(torch.from_numpy(values), ledger=tl, impl=impl)
    t_out = t_dht.lookup(torch.from_numpy(keys), dedup)
    j_out = jl.harvest(j_out)
    t_out = tl.harvest(t_out)
    np.testing.assert_array_equal(t_out, np.asarray(j_out))
    assert _counters(tl) == _counters(jl)
    assert tl.dht_query_waves == jl.dht_query_waves


def test_sharded_dht_default_impl_follows_the_device():
    assert tdht.ShardedDHT(torch.zeros(4)).impl == "take"
    with pytest.raises(ValueError):
        tdht.ShardedDHT(torch.zeros(4), impl="pallas")


def test_lookups_queue_their_counts_until_one_harvest():
    """On a deferred ledger lookups leave their counts on the device; one
    harvest reads every queued record and the caller's tensors, and the
    totals equal the JAX ledger's over the same lookups."""
    values = _table(300, 1, np.int32).reshape(-1)
    batches = [_keys("padding_and_oob", 300, 800),
               _keys("block_edge_runs", 300, 640, seed=2)]
    jl, tl = JLedger("j", deferred=True), TLedger("t", deferred=True)
    j_dht = jdht.ShardedDHT(jnp.asarray(values), ledger=jl, impl="take")
    t_dht = tdht.ShardedDHT(torch.from_numpy(values), ledger=tl, impl="cuda")
    j_outs = [j_dht.lookup(jnp.asarray(k)) for k in batches]
    t_outs = [t_dht.lookup(torch.from_numpy(k)) for k in batches]
    assert len(tl.device) == 2 and _counters(tl) == (0, 0, 0)
    calls = []
    rounds.HARVEST_HOOK = calls.append
    try:
        host = tl.harvest(tuple(t_outs))
    finally:
        rounds.HARVEST_HOOK = None
    jl.harvest()
    assert calls == [tl] and len(tl.device) == 0
    for got, want in zip(host, j_outs):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert _counters(tl) == _counters(jl) != (0, 0, 0)
    assert tl.dht_query_waves == jl.dht_query_waves == 2
