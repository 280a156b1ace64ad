"""Distributed hash table (DHT) — the AMPC primitive (torch).

The paper's DHT stores the previous round's output as key-value pairs with
integer keys known to all machines.  It is a dense tensor indexed by key,
and a lookup is a gather.  This is the port of the JAX package's
``repro.core.dht``, with its two execution schedules:

  * ``lookup`` — the local gather, after ``dedup_keys`` (the paper's
    per-machine caching, Section 5.3);
  * ``routed_lookup`` — the explicit router: each shard dedups its keys,
    buckets them by owner shard, exchanges them all-to-all, answers from
    its own block of rows and routes the answers back.  It runs on two
    kinds of mesh:

      - a :class:`DhtMesh`: the shards are a leading dimension of tensors
        on the values' device, one process (the model of the schedule the
        tests hold everything else to);
      - a ``torch.distributed`` ``DeviceMesh`` (one dimension of it): one
        rank a shard, each running the body of the reference's
        ``shard_map``, the keys and the answers crossing ranks through
        ``all_to_all_single`` (NCCL on the card, gloo on the CPU).  The
        ranks are SPMD copies of one program: each holds the same
        snapshot and the same keys, stores its own block of rows and
        routes its own run of keys.

``ShardedDHT`` serves both.  Without a mesh it has two gather
implementations:

  * ``"take"`` — plain indexing after ``dedup_keys``;
  * ``"cuda"`` — the ``kernels.dht_gather`` cached-gather kernel, whose hit
    count feeds the same ledger counters.  The default on CUDA tensors.

With a mesh every lookup takes the router, which answers by plain
indexing, as the reference's does (``jnp.take``, no Pallas kernel).

``dedup_gather`` reads a table that trains (SASRec's item table) through
the same kernel, with a gradient (:class:`DedupGather`).

A deferred ledger's counts stay on the device: they go to the ledger
through ``RoundLedger.record_queries_deferred`` and nothing here reads
them (on a process group they are summed over the ranks by an
``all_reduce`` on the device).  An eager ledger (``deferred=False``) gets
them at once; its local take path reads two counts per lookup, as the
reference's does, the router one record.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import torch

from ..devices import axis_group, is_device_mesh
from ..placement import dtensor_types
from .rounds import to_host

INT_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class DhtMesh:
    """The shard grid a routed DHT runs on: ``shape[axis_name]`` is the
    number of shards, as on the reference's ``jax.sharding.Mesh``.  Every
    shard lives on the values' own device."""

    shape: Mapping[str, int]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)


def make_mesh(n_shards: int, axis_name: str = "dht") -> DhtMesh:
    """A one-axis :class:`DhtMesh` of ``n_shards`` shards."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    return DhtMesh({axis_name: int(n_shards)})


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a :class:`DhtMesh` or a ``DeviceMesh``."""
    if is_device_mesh(mesh):
        return tuple(mesh.mesh_dim_names or ())
    return mesh.axis_names


def group_key(mesh, axis_name: str):
    """A hashable name of the ranks that the ``axis_name`` dimension of a
    ``DeviceMesh`` spans: its device type, the axis and the ranks."""
    group = axis_group(mesh, axis_name, "a DeviceMesh DHT")[0]
    return ("group", mesh.device_type, axis_name,
            tuple(torch.distributed.get_process_group_ranks(group)))


def _group_of(mesh, axis_name, values: torch.Tensor):
    """(group, P, rank) of the router's dimension of a ``DeviceMesh``;
    raises, never falls back, where the mesh's device type is not the
    values'."""
    group = axis_group(mesh, axis_name, "the DHT router")
    if mesh.device_type != values.device.type:
        raise ValueError(f"the DHT router's mesh is on {mesh.device_type!r} "
                         f"and its values on {values.device.type!r}")
    return group


def dedup_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Sort-dedup a key batch (the paper's per-machine caching).

    Returns (uniq, inv, n_unique):
      uniq  — (K,) int32 sorted unique keys first, INT_MAX padding after;
      inv   — (K,) int32 position of each original key inside ``uniq``;
      n_unique — 0-d count of distinct keys.
    Negative keys are treated as invalid (padding) and map to INT_MAX.
    """
    keys = keys.to(torch.int32)
    safe = torch.where(keys < 0, INT_MAX, keys)
    K = safe.shape[0]
    dev = keys.device
    if K == 0:
        return (torch.full((0,), INT_MAX, dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    # one sort, then group arithmetic on the sorted view: `grp` numbers the
    # distinct values in ascending order, so scattering first-of-group
    # values lands uniq already sorted, and `grp` mapped back through
    # `order` is the inverse index (invalid keys share the INT_MAX group,
    # whose index is exactly n_unique)
    sk, order = torch.sort(safe, stable=True)
    newgrp = torch.ones(K, dtype=torch.bool, device=dev)
    newgrp[1:] = sk[1:] != sk[:-1]
    valid_first = newgrp & (sk != INT_MAX)
    n_unique = valid_first.sum()
    grp = torch.cumsum(newgrp, 0) - 1
    # slot K is the drop slot for every non-first entry
    uniq = torch.full((K + 1,), INT_MAX, dtype=torch.int32, device=dev)
    uniq[torch.where(valid_first, grp, K)] = sk
    inv = torch.empty(K, dtype=torch.int32, device=dev)
    inv[order] = grp.to(torch.int32)
    return uniq[:K], inv, n_unique


def lookup(values: torch.Tensor, keys: torch.Tensor, dedup: bool = True):
    """Gather ``values[keys]`` with optional dedup caching.

    Invalid (negative) keys return row 0 — callers mask them.
    Returns (gathered, n_unique_queries).
    """
    keys = keys.to(torch.int32)
    last = values.shape[0] - 1
    if not dedup:
        safe = keys.clamp(0, last).long()
        return values[safe], torch.tensor(keys.numel(), dtype=torch.int64,
                                          device=keys.device)
    uniq, inv, n_unique = dedup_keys(keys)
    safe = torch.where(uniq == INT_MAX, 0, uniq).clamp(0, last).long()
    fetched = values[safe]
    return fetched[inv.long()], n_unique


class DedupGather(torch.autograd.Function):
    """``apply(values, rows, zero_rows)`` -> ``values[rows]`` (Q, D) for a
    (V, D) table and (Q,) int32 row ids in [0, V) (with ``zero_rows``, -1
    too: a zero row that takes no gradient).

    The forward is ``kernels.dht_gather``'s sorted, deduplicated gather:
    the Hopper kernel on CUDA tensors, its plain version on CPU tensors.
    The backward adds each output row's gradient into the row it read
    (``index_add_``), a dense (V, D) gradient as ``jax.grad`` of the
    reference's gather gives; on the card its atomics make the f32 bits
    of rows read more than once vary from run to run.
    """

    @staticmethod
    def forward(ctx, values, rows, zero_rows: bool):
        from ..kernels.dht_gather.ops import dht_gather

        out, _ = dht_gather(values, rows)
        ctx.save_for_backward(rows)
        ctx.n_rows, ctx.zero_rows = values.shape[0], zero_rows
        return out

    @staticmethod
    def backward(ctx, dout):
        (rows,) = ctx.saved_tensors
        grad = torch.zeros((ctx.n_rows, dout.shape[1]), dtype=dout.dtype,
                           device=dout.device)
        if ctx.zero_rows:
            # a -1 row adds a zero into row 0: no count is read back
            valid = rows >= 0
            rows = torch.where(valid, rows, 0)
            dout = torch.where(valid[:, None], dout, 0.0)
        grad.index_add_(0, rows.long(), dout)
        return grad, None, None


def dedup_gather(values: torch.Tensor, keys, sctx=None) -> torch.Tensor:
    """``values[keys]`` for a (V, D) table that may train and keys of any
    shape: (keys.shape + (D,)), read as the reference's ``lookup(values,
    keys, dedup=True)`` reads them: negative keys read row 0, keys past
    the end read row V - 1.  Through :class:`DedupGather`.

    Under a ``ShardCtx`` (``sctx``; ``values`` a DTensor, its rows over
    the model axis or replicated, ``keys`` a DTensor) the call is an
    explicit region on the local shards: the keys clamped on global ids
    first, each mapped to its row in this rank's slice of the table or to
    -1 (the kernel's zero row) where another model rank holds it, the
    ``dht_gather`` kernel run on the local slice, and the rows summed over
    the model axis (an all-reduce).  The result has the keys' placements.
    In the backward each model rank adds the gradient into the rows it
    holds: the (V, D) gradient stays split over the model axis, a partial
    sum over the axes that split the keys, which the step sums before
    AdamW.  No rank gathers the table."""
    if values.dim() != 2:
        raise ValueError(f"values must be (V, D), got {tuple(values.shape)}")
    if values.shape[0] == 0:
        raise ValueError("cannot gather from a table without rows")
    if sctx is not None:
        return _sharded_gather(values, keys, sctx)
    keys = torch.as_tensor(keys, device=values.device).to(torch.int32)
    rows = keys.reshape(-1).clamp(0, values.shape[0] - 1)
    out = DedupGather.apply(values, rows, False)
    return out.reshape(keys.shape + (values.shape[1],))


def _sharded_gather(values, keys, sctx):
    _, Partial, Replicate, Shard = dtensor_types()
    t_pl, k_pl = tuple(values.placements), tuple(keys.placements)
    V = values.shape[0]
    split = [p.is_shard() for p in t_pl]
    # where the table is split a rank's rows are the rest's zeros (a
    # partial sum), elsewhere the rows follow the keys
    out_pl = tuple(Partial() if t else k for t, k in zip(split, k_pl))
    grad_pl = tuple(Shard(0) if t else Partial() if k.is_shard()
                    else Replicate() for t, k in zip(split, k_pl))
    mesh_dims = [d for d, t in enumerate(split) if t]
    owner = 0
    for d in mesh_dims:
        owner = owner * sctx.mesh.size(d) + sctx.mesh.get_local_rank(d)

    def region(table, k):
        Vl = table.shape[0]
        rows = k.reshape(-1).to(torch.int32).clamp(0, V - 1) - owner * Vl
        local = torch.where((rows >= 0) & (rows < Vl), rows, -1)
        out = DedupGather.apply(table, local, True)
        return out.reshape(k.shape + (table.shape[1],))

    out = sctx.local(region, [out_pl], [t_pl, k_pl], [grad_pl, k_pl])(
        values, keys)
    return out.redistribute(sctx.mesh, tuple(
        Replicate() if p.is_partial() else p for p in out_pl))


def _dedup_rows(keys: torch.Tensor):
    """``dedup_keys`` of each row of a (P, K) int32 key batch at once: a
    batched stable sort, then the same group arithmetic.  Returns (uniq,
    inv, n_unique) of shapes (P, K), (P, K) and (P,)."""
    P, K = keys.shape
    dev = keys.device
    safe = torch.where(keys < 0, INT_MAX, keys)
    sk, order = torch.sort(safe, dim=1, stable=True)
    newgrp = torch.ones((P, K), dtype=torch.bool, device=dev)
    newgrp[:, 1:] = sk[:, 1:] != sk[:, :-1]
    valid_first = newgrp & (sk != INT_MAX)
    n_unique = valid_first.sum(1)
    grp = torch.cumsum(newgrp, 1) - 1
    # column K of each row is the drop slot for every non-first entry
    uniq = torch.full((P, K + 1), INT_MAX, dtype=torch.int32, device=dev)
    uniq.scatter_(1, torch.where(valid_first, grp, K), sk)
    inv = torch.empty((P, K), dtype=torch.int64, device=dev)
    inv.scatter_(1, order, grp)
    return uniq[:, :K], inv, n_unique


def _owner(keys: torch.Tensor, shard_size: int) -> torch.Tensor:
    """The shard that holds each key's row; INT_MAX for padding."""
    return torch.where(keys == INT_MAX, INT_MAX, keys // shard_size)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[p, idx[p, j]]`` for a (P, N, ...) tensor and (P, J) indices."""
    shard = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[shard, idx]


def _bucket(k: torch.Tensor, P: int, shard_size: int, cap: int,
            dedup: bool):
    """Bucket each row of a (R, q) int32 key batch (one shard's run a row)
    by owner into ``cap`` slots an owner.

    Each run's keys go in owner order with each key's slot in its owner's
    bucket.  Dedup leaves a row ascending, and the owner grows with the
    key, so its keys are in owner order already; without dedup a stable
    sort keeps the caller's order within an owner.  Returns (send (R, P *
    cap) int32, INT_MAX in empty slots; owner and slot (R, q) of each
    sorted key, clamped into the buffer; valid (R, q), the keys sent;
    undo, the dedup's inverse or the owner sort's permutation; n_unique
    (R,); overflow (R,)).
    """
    R, q_local = k.shape
    dev = k.device
    if dedup:
        sk, undo, n_unique = _dedup_rows(k)
    else:
        safe = torch.where(k < 0, INT_MAX, k)
        undo = torch.sort(_owner(safe, shard_size), dim=1,
                          stable=True).indices
        sk = safe.gather(1, undo)
        n_unique = (k >= 0).sum(1)
    so = _owner(sk, shard_size).long()
    owners = torch.arange(P, dtype=torch.int64, device=dev).expand(R, P)
    start = torch.searchsorted(so.contiguous(), owners.contiguous())
    slot = torch.arange(q_local, device=dev) - start.gather(
        1, so.clamp(0, P - 1))
    live = sk != INT_MAX
    valid = live & (slot < cap) & (so < P)
    overflow = (live & (slot >= cap)).sum(1)
    # the send buffer: (P destinations x cap slots) and one drop slot,
    # where every padding and overflowed key lands
    flat_pos = torch.where(valid, so * cap + slot, P * cap)
    send = torch.full((R, P * cap + 1), INT_MAX, dtype=torch.int32,
                      device=dev)
    send.scatter_(1, flat_pos, torch.where(valid, sk, INT_MAX))
    return (send[:, :-1], so.clamp(0, P - 1), slot.clamp(0, cap - 1), valid,
            undo, n_unique, overflow)


def _unbucket(back, owner, slot, valid, undo, dedup: bool):
    """The answers to each run's sorted keys, ``back`` (R, P, cap, ...),
    read at their owner and slot, 0 where a key was not sent, and put back
    in the run's own order: through the dedup's inverse, or the owner
    sort's permutation.  Returns (R, q, ...)."""
    shard = torch.arange(valid.shape[0], device=valid.device)[:, None]
    got = back[shard, owner, slot]
    got.masked_fill_((~valid).reshape(valid.shape + (1,) * (got.dim() - 2)),
                     0)
    if dedup:
        return _rows(got, undo)
    out = torch.empty_like(got)
    out[shard, undo] = got
    return out


def routed_lookup(values: torch.Tensor, keys: torch.Tensor, mesh,
                  axis_name: str, capacity: int | None = None,
                  dedup: bool = True):
    """Explicit DHT router: dedup -> bucket by owner -> all-to-all ->
    answer -> all-to-all back -> un-dedup.

    On a :class:`DhtMesh`, for every shard at once: ``values`` is (n, ...)
    rows, shard ``p`` owning the contiguous block ``[p * n / P, (p + 1) *
    n / P)``; ``keys`` is (Q,) int32, shard ``p`` sending the ``p``-th run
    of Q / P of them; the result is (Q, ...).

    On a ``DeviceMesh`` (its dimension ``axis_name``, P ranks), each rank
    passes what the reference's ``shard_map`` body gets: ``values`` its
    own block of rows (the same count on every rank) and ``keys`` its own
    run (the same length on every rank), and gets its run's answers.  The
    keys go out in one ``all_to_all_single`` of a (P, cap) int32 buffer and
    the answers come back in a second, of (P * cap, ...) rows in the
    values' type; the shapes are fixed, so every rank issues the same
    collectives.  Raises where ``torch.distributed`` is not initialized or
    the mesh is on another device type than the values.

    -1 keys are padding.  ``capacity`` is the slots a shard has for each
    owner; keys past it in their owner's bucket overflow, are not answered
    and read 0, as padding does.  The default, the run's length, is exact.
    Returns (gathered, n_unique, overflow_count) with the counts as 0-d
    device tensors summed over the shards (each shard counts its own
    distinct keys; on a process group one ``all_reduce``).  Nothing here
    syncs with the host.
    """
    if is_device_mesh(mesh):
        return _group_routed_lookup(values, keys, mesh, axis_name, capacity,
                                    dedup)
    P = mesh.shape[axis_name]
    n, Q = values.shape[0], keys.shape[0]
    if n % P or Q % P:
        raise ValueError(f"value rows ({n}) and keys ({Q}) must divide "
                         f"evenly across {P} shards")
    shard_size, q_local = n // P, Q // P
    cap = capacity or q_local
    shard = torch.arange(P, device=values.device)[:, None]
    send, owner, slot, valid, undo, n_unique, overflow = _bucket(
        keys.to(torch.int32).reshape(P, q_local), P, shard_size, cap, dedup)
    # all-to-all: recv[d, s] is what shard s sent to shard d
    recv = send.reshape(P, P, cap).transpose(0, 1)
    # each shard answers from its own block of rows (an empty slot reads
    # the block's row 0: it is never read back)
    local_idx = torch.where(recv == INT_MAX, 0,
                            recv - shard[:, :, None] * shard_size)
    local_idx = local_idx.clamp(0, shard_size - 1).long().reshape(P, P * cap)
    blocks = values.reshape((P, shard_size) + tuple(values.shape[1:]))
    ans = _rows(blocks, local_idx)
    # and the answers go back the same way: back[s, d] came from shard d
    back = ans.reshape((P, P, cap) + tuple(ans.shape[2:])).transpose(0, 1)
    out = _unbucket(back, owner, slot, valid, undo, dedup)
    return (out.reshape((Q,) + tuple(values.shape[1:])), n_unique.sum(),
            overflow.sum())


def _group_routed_lookup(block, keys, mesh, axis_name, capacity, dedup):
    """One rank's part of ``routed_lookup`` on a ``DeviceMesh``: the body
    of the reference's ``shard_map``, its two ``all_to_all``s on the
    process group."""
    import torch.distributed as dist
    group, P, rank = _group_of(mesh, axis_name, block)
    shard_size, q_local = block.shape[0], keys.shape[0]
    cap = capacity or q_local
    send, owner, slot, valid, undo, n_unique, overflow = _bucket(
        keys.to(torch.int32).reshape(1, q_local), P, shard_size, cap, dedup)
    # recv[s * cap:(s + 1) * cap] are the keys rank s sent here
    recv = torch.empty(P * cap, dtype=torch.int32, device=block.device)
    dist.all_to_all_single(recv, send[0], group=group)
    # answer from this rank's own block (an empty slot reads its row 0:
    # it is never read back), then route the answers back
    local_idx = torch.where(recv == INT_MAX, 0, recv - rank * shard_size)
    ans = block[local_idx.clamp(0, shard_size - 1).long()]
    back = torch.empty_like(ans)
    dist.all_to_all_single(back, ans, group=group)
    out = _unbucket(back.reshape((1, P, cap) + tuple(back.shape[1:])),
                    owner, slot, valid, undo, dedup)
    counts = torch.stack([n_unique.sum(), overflow.sum()])
    dist.all_reduce(counts, group=group)
    return out[0], counts[0], counts[1]


def _fused_local_lookup(values, keys, row_bytes: int, dedup: bool):
    """The take-path gather plus every counter the ledger records
    (queries, bytes, dedup savings), as device tensors."""
    valid = (keys >= 0).sum()
    out, n_unique = lookup(values, keys, dedup=dedup)
    if not dedup:
        n_unique = valid
    nbytes = n_unique * (row_bytes + 4)
    deduped = (valid - n_unique) if dedup else 0
    return out, n_unique, nbytes, deduped


class ShardedDHT:
    """Immutable DHT snapshot with uniform ledger accounting.

    Without a ``mesh`` every lookup takes the local gather path, served by
    ``impl`` (``None`` picks ``"cuda"`` for CUDA values and ``"take"``
    otherwise); with a ``mesh`` it takes the router (``routed_lookup``)
    over the shards of the mesh's ``axis_name`` dimension, each with
    ``capacity`` slots an owner.  Both report query / byte / dedup /
    overflow counters through the same ledger calls, so AMPC accounting is
    backend-independent.

    On a ``DeviceMesh`` every rank builds the snapshot from the same
    ``values`` and looks up the same keys: it keeps a view of its own
    block of the padded rows, routes its own run of the keys, and
    all-gathers the runs' answers, so every rank gets the whole (Q, ...)
    result (the reference's sharded output, read whole).
    """

    def __init__(self, values: torch.Tensor, ledger=None,
                 value_bytes: int | None = None, mesh=None,
                 axis_name: str = "dht", capacity: int | None = None,
                 impl: str | None = None):
        self.values = values
        self.ledger = ledger
        self.mesh = mesh
        self.axis_name = axis_name
        self.capacity = capacity
        self._row_bytes = value_bytes or int(
            values.element_size() * (values.numel()
                                     // max(values.shape[0], 1)))
        if impl is None:
            impl = "cuda" if values.is_cuda else "take"
        if impl not in ("take", "cuda"):
            raise ValueError(f"impl must be 'take' or 'cuda', got {impl!r}")
        self.impl = impl
        # routed path: pad the rows to the shard grid once a snapshot; on a
        # process group keep a view of this rank's block
        self._group = None
        if mesh is not None:
            if is_device_mesh(mesh):
                self._group = _group_of(mesh, axis_name, values)
                self._shards = self._group[1]
            else:
                self._shards = mesh.shape[axis_name]
            pad_rows = (-values.shape[0]) % self._shards
            self._padded_values = values
            if pad_rows:
                fill = values.new_zeros((pad_rows,) + tuple(values.shape[1:]))
                self._padded_values = torch.cat([values, fill])
            if self._group is not None:
                size = self._padded_values.shape[0] // self._shards
                rank = self._group[2]
                self._padded_values = self._padded_values[
                    rank * size:(rank + 1) * size]

    @property
    def backend(self) -> str:
        return "local" if self.mesh is None else "routed"

    def _routed(self, keys, dedup: bool):
        """Pad the keys to the shard grid with -1, route, slice back.  On
        a process group route this rank's run and all-gather the runs."""
        q = keys.numel()
        pad_q = (-q) % self._shards
        k = keys
        if pad_q:
            k = torch.cat([k, k.new_full((pad_q,), -1)])
        if self._group is None:
            out, n_unique, overflow = routed_lookup(
                self._padded_values, k, self.mesh, self.axis_name,
                capacity=self.capacity, dedup=dedup)
            return out[:q], n_unique, overflow
        import torch.distributed as dist
        group, P, rank = self._group
        q_local = k.numel() // P
        run, n_unique, overflow = routed_lookup(
            self._padded_values, k[rank * q_local:(rank + 1) * q_local],
            self.mesh, self.axis_name, capacity=self.capacity, dedup=dedup)
        out = run.new_empty((P * q_local,) + tuple(run.shape[1:]))
        # all_gather_single is all_gather_into_tensor's newer name
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out, run, group=group)
        return out[:q], n_unique, overflow

    def _cuda_gather(self, keys):
        """Cached-gather kernel path: returns (out, cache_hits).

        The kernel's hit count satisfies ``hits == valid - distinct``, so
        the caller derives ``n_unique = valid - hits``, equal to the
        ``dedup_keys`` count.  Invalid keys are re-pointed at row 0
        afterwards to match the take path's output contract.
        """
        from ..kernels.dht_gather.ops import dht_gather

        values = self.values
        table = values.reshape(values.shape[0], -1)
        out, hits = dht_gather(table, torch.where(keys < 0, -1, keys))
        out = out.reshape(keys.shape + values.shape[1:])
        invalid = (keys < 0).reshape((-1,) + (1,) * (values.dim() - 1))
        out = torch.where(invalid, values[0], out)
        return out, hits

    def lookup(self, keys, dedup: bool = True):
        keys = torch.as_tensor(keys, dtype=torch.int32,
                               device=self.values.device)
        tracer = getattr(self.ledger, "tracer", None)
        if tracer is not None and tracer.enabled:
            with tracer.span("dht:lookup", backend=self.backend,
                             keys=int(keys.numel()), dedup=dedup):
                return self._lookup(keys, dedup)
        return self._lookup(keys, dedup)

    def _lookup(self, keys, dedup: bool):
        # negative keys are padding: they are never queried, so they count
        # neither as queries nor as dedup savings, on either backend.
        # Every count below stays on the device; the ledger decides when to
        # read it.
        ledger = self.ledger
        if keys.numel() == 0:
            # nothing to exchange on any backend, and the router cannot pad
            # an empty batch onto the shard grid: answer with an empty
            # gather and record zeros (host ints: no transfer)
            if ledger is not None:
                ledger.record_queries(0, 0, waves=0)
            return torch.zeros(keys.shape + self.values.shape[1:],
                               dtype=self.values.dtype,
                               device=self.values.device)
        eager = ledger is not None and not ledger.deferred
        overflow = 0
        if self.mesh is not None:
            valid = (keys >= 0).sum()
            out, n_unique, overflow = self._routed(keys, dedup)
            nbytes = n_unique * (self._row_bytes + 4)
            deduped = (valid - n_unique) if dedup else 0
        elif dedup and self.impl == "cuda" and self.values.numel():
            valid = (keys >= 0).sum()
            out, hits = self._cuda_gather(keys)
            n_unique = valid - hits
            nbytes = n_unique * (self._row_bytes + 4)
            deduped = hits
        elif eager:
            # the reference's eager take path: one read of the valid count
            # before the gather and one of the distinct count after it
            valid = int(to_host([(keys >= 0).sum()])[0])
            out, n_unique = lookup(self.values, keys, dedup=dedup)
            nu = int(to_host([n_unique])[0]) if dedup else valid
            ledger.record_queries(nu, nu * (self._row_bytes + 4), waves=1,
                                  deduped_away=(valid - nu) if dedup else 0)
            return out
        else:
            out, n_unique, nbytes, deduped = _fused_local_lookup(
                self.values, keys, self._row_bytes, dedup)
        if ledger is not None:
            ledger.record_queries_deferred(
                n_unique, nbytes, waves=1, deduped_away=deduped,
                overflow=overflow)
        return out
