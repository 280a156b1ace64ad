"""Distributed hash table (DHT) — the AMPC primitive (torch).

The paper's DHT stores the previous round's output as key-value pairs with
integer keys known to all machines.  It is a dense tensor indexed by key,
and a lookup is a gather.  This is the port of the JAX package's
``repro.core.dht``, with its two execution schedules:

  * ``lookup`` — the local gather, after ``dedup_keys`` (the paper's
    per-machine caching, Section 5.3);
  * ``routed_lookup`` — the explicit router: each shard dedups its keys,
    buckets them by owner shard, exchanges them all-to-all, answers from
    its own block of rows and routes the answers back.  The shards are a
    leading dimension of tensors on the values' device (a :class:`DhtMesh`
    names how many), the counterpart of the reference's mesh over the
    devices of one host.

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
them.  An eager ledger (``deferred=False``) gets them at once; its local
take path reads two counts per lookup, as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import torch

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
    """``apply(values, keys)`` -> ``values[keys]`` (Q, D) for a (V, D)
    table and (Q,) int32 keys, read as the reference's ``lookup(values,
    keys, dedup=True)`` reads them: negative keys read row 0, keys past the
    end read row V - 1.

    The forward is ``kernels.dht_gather``'s sorted, deduplicated gather:
    the Hopper kernel on CUDA tensors, its plain version on CPU tensors.
    The backward adds each output row's gradient into the row it read
    (``index_add_``), a dense (V, D) gradient as ``jax.grad`` of the
    reference's gather gives; on the card its atomics make the f32 bits
    of rows read more than once vary from run to run.
    """

    @staticmethod
    def forward(ctx, values, keys):
        from ..kernels.dht_gather.ops import dht_gather

        # the kernel's padding is -1 (a zero row); the reference reads row
        # 0 for a negative key, so those keys ask for row 0
        rows = keys.clamp(min=0)
        out, _ = dht_gather(values, rows)
        ctx.save_for_backward(rows)
        ctx.n_rows = values.shape[0]
        return out

    @staticmethod
    def backward(ctx, dout):
        (rows,) = ctx.saved_tensors
        grad = torch.zeros((ctx.n_rows, dout.shape[1]), dtype=dout.dtype,
                           device=dout.device)
        grad.index_add_(0, rows.clamp(max=ctx.n_rows - 1).long(), dout)
        return grad, None


def dedup_gather(values: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """``values[keys]`` for a (V, D) table that may train and keys of any
    shape: (keys.shape + (D,)), through :class:`DedupGather`."""
    if values.dim() != 2:
        raise ValueError(f"values must be (V, D), got {tuple(values.shape)}")
    if values.shape[0] == 0:
        raise ValueError("cannot gather from a table without rows")
    keys = torch.as_tensor(keys, device=values.device).to(torch.int32)
    out = DedupGather.apply(values, keys.reshape(-1))
    return out.reshape(keys.shape + (values.shape[1],))


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


def routed_lookup(values: torch.Tensor, keys: torch.Tensor, mesh,
                  axis_name: str, capacity: int | None = None,
                  dedup: bool = True):
    """Explicit DHT router: dedup -> bucket by owner -> all-to-all ->
    answer -> all-to-all back -> un-dedup, for every shard at once.

    ``values``: (n, ...) rows, shard ``p`` owning the contiguous block
    ``[p * n / P, (p + 1) * n / P)``; ``keys``: (Q,) int32, shard ``p``
    sending the ``p``-th run of Q / P of them; -1 = padding.  ``capacity``
    is the slots a shard has for each owner; keys past it in their owner's
    bucket overflow, are not answered and read 0, as padding does.  The
    default, Q / P, is exact.  Returns (gathered (Q, ...), n_unique,
    overflow_count) with the counts as 0-d device tensors: n_unique sums
    the shards' own distinct counts.  Nothing here syncs with the host.
    """
    P = mesh.shape[axis_name]
    n, Q = values.shape[0], keys.shape[0]
    if n % P or Q % P:
        raise ValueError(f"value rows ({n}) and keys ({Q}) must divide "
                         f"evenly across {P} shards")
    shard_size, q_local = n // P, Q // P
    cap = capacity or q_local
    dev = values.device
    shard = torch.arange(P, device=dev)[:, None]
    k = keys.to(torch.int32).reshape(P, q_local)
    # each shard's keys in owner order, and each key's slot within its
    # owner's bucket.  Dedup leaves a row ascending, and the owner grows
    # with the key, so its keys are in owner order already; without dedup
    # a stable sort keeps the caller's order within an owner
    if dedup:
        sk, inv, n_unique = _dedup_rows(k)
    else:
        safe = torch.where(k < 0, INT_MAX, k)
        order = torch.sort(_owner(safe, shard_size), dim=1,
                           stable=True).indices
        sk = safe.gather(1, order)
        n_unique = (k >= 0).sum(1)
    so = _owner(sk, shard_size).long()
    owners = torch.arange(P, dtype=torch.int64, device=dev).expand(P, P)
    start = torch.searchsorted(so.contiguous(), owners.contiguous())
    slot = torch.arange(q_local, device=dev) - start.gather(
        1, so.clamp(0, P - 1))
    live = sk != INT_MAX
    valid = live & (slot < cap) & (so < P)
    overflow = (live & (slot >= cap)).sum(1)
    # the send buffer: (P destinations x cap slots) and one drop slot,
    # where every padding and overflowed key lands
    flat_pos = torch.where(valid, so * cap + slot, P * cap)
    send = torch.full((P, P * cap + 1), INT_MAX, dtype=torch.int32,
                      device=dev)
    send.scatter_(1, flat_pos, torch.where(valid, sk, INT_MAX))
    # all-to-all: recv[d, s] is what shard s sent to shard d
    recv = send[:, :-1].reshape(P, P, cap).transpose(0, 1)
    # each shard answers from its own block of rows (an empty slot reads
    # the block's row 0: it is never read back)
    local_idx = torch.where(recv == INT_MAX, 0,
                            recv - shard[:, :, None] * shard_size)
    local_idx = local_idx.clamp(0, shard_size - 1).long().reshape(P, P * cap)
    blocks = values.reshape((P, shard_size) + tuple(values.shape[1:]))
    ans = _rows(blocks, local_idx)
    # and the answers go back the same way: back[s, d] came from shard d
    back = ans.reshape((P, P, cap) + tuple(ans.shape[2:])).transpose(0, 1)
    got = back[shard, so.clamp(0, P - 1), slot.clamp(0, cap - 1)]
    got.masked_fill_((~valid).reshape(valid.shape + (1,) * (got.dim() - 2)),
                     0)
    # back to the caller's order: through the dedup's inverse, or the
    # owner sort's permutation
    if dedup:
        out = _rows(got, inv)
    else:
        out = torch.empty_like(got)
        out[shard, order] = got
    return (out.reshape((Q,) + tuple(values.shape[1:])), n_unique.sum(),
            overflow.sum())


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
    over ``mesh.shape[axis_name]`` shards, each with ``capacity`` slots an
    owner.  Both report query / byte / dedup / overflow counters through
    the same ledger calls, so AMPC accounting is backend-independent.
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
        # routed path: pad the rows to the shard grid once a snapshot
        if mesh is not None:
            pad_rows = (-values.shape[0]) % mesh.shape[axis_name]
            self._padded_values = values
            if pad_rows:
                fill = values.new_zeros((pad_rows,) + tuple(values.shape[1:]))
                self._padded_values = torch.cat([values, fill])

    @property
    def backend(self) -> str:
        return "local" if self.mesh is None else "routed"

    def _routed(self, keys, dedup: bool):
        """Pad the keys to the shard grid with -1, route, slice back."""
        q = keys.numel()
        pad_q = (-q) % self.mesh.shape[self.axis_name]
        k = keys
        if pad_q:
            k = torch.cat([k, k.new_full((pad_q,), -1)])
        out, n_unique, overflow = routed_lookup(
            self._padded_values, k, self.mesh, self.axis_name,
            capacity=self.capacity, dedup=dedup)
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
