"""DHT backends for the port's AMPC engine.

The paper's AMPC model has one shared primitive: an immutable distributed
hash table written by the previous round and queried adaptively inside the
current one.  ``core.dht`` runs it on two schedules, a local gather
(``LocalDht``) and an explicit all-to-all router over shards
(``RoutedDht``: shards on one device, or one rank a shard over a
``torch.distributed`` process group); both sit behind one ``DhtBackend``
protocol, so a solver
issues lookups without knowing which schedule runs, and the ledger's
counters (queries, bytes, dedup savings, waves, overflows) are kept the
same way on both.  A backend binds a value tensor and a ledger into a
``core.dht.ShardedDHT`` snapshot, and every query goes through
``ShardedDHT.lookup`` — the single accounting choke point.
``lookup_many`` is the batched (``solve_many``) variant: one exchange
serves a whole shape bucket, with per-graph query counts split by the
padding mask.
"""
from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..core.dht import ShardedDHT, make_mesh, mesh_axis_names
from ..core.rounds import RoundLedger
from ..devices import axis_group, is_device_mesh, world_mesh
from ..obs import trace as obs_trace


@runtime_checkable
class DhtBackend(Protocol):
    """One immutable-snapshot KV store, the only AMPC communication
    primitive."""

    name: str

    def snapshot(self, values, ledger=None,
                 value_bytes: Optional[int] = None) -> ShardedDHT:
        """Write ``values`` (row i = value of key i) into the DHT."""
        ...

    def lookup(self, values, keys, *, ledger=None, dedup: bool = True,
               value_bytes: Optional[int] = None):
        """One-shot snapshot + query batch (convenience for single reads)."""
        ...

    def lookup_many(self, values, keys, *, ledgers=None, key_mask=None,
                    dedup: bool = False, value_bytes: Optional[int] = None):
        """Batched snapshot read over a graph batch (see ``_BackendBase``)."""
        ...


class _BackendBase:
    def lookup(self, values, keys, *, ledger=None, dedup: bool = True,
               value_bytes: Optional[int] = None):
        return self.snapshot(values, ledger=ledger,
                             value_bytes=value_bytes).lookup(keys, dedup=dedup)

    def lookup_many(self, values, keys, *, ledgers=None, key_mask=None,
                    dedup: bool = False, value_bytes: Optional[int] = None):
        """One exchange serving a whole ``solve_many`` bucket.

        ``values`` is (B, n, ...) — graph ``b``'s snapshot in row ``b`` —
        and ``keys`` is (B, K) int32.  The batch is flattened into a single
        keyspace (graph ``b``'s key ``k`` becomes ``b * n + k``) so the
        gather runs **once** for the whole bucket; graphs cannot alias each
        other's rows because their key ranges are disjoint.

        ``key_mask`` (B, K), a host array (the bucket's padding mask),
        marks the real queries: masked lanes become the ``-1`` padding keys
        the DHT ignores.  When ``ledgers`` is given (one
        ``RoundLedger`` per graph, batch order), each graph's ledger records
        *its own* valid-query count and bytes.  The exchange's overflow
        count is recorded on **every** participating ledger, so per graph
        ``dht_overflows == 0`` still certifies exact answers.  With the
        default ``dedup=False`` the read is a plain gather (no kernel), as
        the reference's is a ``take``.  Returns the gathered (B, K, ...)
        tensor.
        """
        values = torch.as_tensor(values)
        keys = torch.as_tensor(keys, device=values.device).to(torch.int32)
        B, n = values.shape[0], values.shape[1]
        tracer = next((led.tracer for led in (ledgers or ())
                       if led is not None and led.tracer is not None
                       and led.tracer.enabled), None)
        if tracer is None:
            # solve_many bucket ledgers carry no tracer (the engine emits
            # per-graph spans afterwards); attach the batched exchange to
            # whatever bucket span is open instead
            amb = obs_trace.current_tracer()
            tracer = amb if amb.enabled else None
        if tracer is not None:
            with tracer.span("dht:lookup_many", backend=self.name, batch=B,
                             keys_per_graph=int(keys.shape[1])):
                return self._lookup_many(values, keys, B, n,
                                         ledgers=ledgers, key_mask=key_mask,
                                         dedup=dedup, value_bytes=value_bytes)
        return self._lookup_many(values, keys, B, n, ledgers=ledgers,
                                 key_mask=key_mask, dedup=dedup,
                                 value_bytes=value_bytes)

    def _lookup_many(self, values, keys, B, n, *, ledgers, key_mask, dedup,
                     value_bytes):
        dev = values.device
        flat_vals = values.reshape((B * n,) + tuple(values.shape[2:]))
        offset = (torch.arange(B, dtype=torch.int32, device=dev) * n)[:, None]
        flat_keys = keys + offset
        if key_mask is not None:
            mask = torch.as_tensor(key_mask, device=dev)
            flat_keys = torch.where(mask, flat_keys, -1)
        # scratch ledger: captures the exchange's overflow count without
        # recording the query totals twice; they are re-attributed per
        # graph below.  Deferred, so its records stay device values.
        scratch = RoundLedger("lookup_many", deferred=True)
        snap = self.snapshot(flat_vals, ledger=scratch,
                             value_bytes=value_bytes)
        out = snap.lookup(flat_keys.reshape(-1), dedup=dedup)
        out = out.reshape((B, keys.shape[1]) + tuple(out.shape[1:]))
        if ledgers is not None:
            pending = scratch.device.drain()
            # record layout: (queries, nbytes, waves, deduped_away, overflow)
            overflow = pending[-1][0][4] if pending else 0
            if key_mask is None:
                counts = [int(keys.shape[1])] * B
            else:
                counts = [int(c) for c in np.sum(np.asarray(key_mask),
                                                 axis=1)]
            row_bytes = value_bytes or snap._row_bytes
            for ledger, cnt in zip(ledgers, counts):
                if ledger is not None:
                    ledger.record_queries_deferred(
                        cnt, cnt * (row_bytes + 4), waves=1,
                        overflow=overflow)
        return out


class LocalDht(_BackendBase):
    """Gather-based DHT on the values' own device."""

    name = "local"

    def snapshot(self, values, ledger=None,
                 value_bytes: Optional[int] = None) -> ShardedDHT:
        return ShardedDHT(torch.as_tensor(values), ledger=ledger,
                          value_bytes=value_bytes)

    def __repr__(self):
        return "LocalDht()"


class RoutedDht(_BackendBase):
    """Explicit router DHT: dedup -> bucket by owner -> all-to-all ->
    answer (``core.dht.routed_lookup``), the collective schedule an RDMA KV
    store replaces (paper Section 5).

    ``mesh`` names the shards on ``axis_name``: a ``core.dht.DhtMesh``
    (shards on the values' device, one process) or a ``torch.distributed``
    ``DeviceMesh`` (one rank a shard; every rank runs the same solve, see
    ``core.dht``).  Without one, while a default process group is
    initialized, a 1-D ``("dht",)`` ``DeviceMesh`` over every rank (on
    ``cuda`` under NCCL, ``cpu`` under gloo), the counterpart of the
    reference's mesh over every visible device; with no process group a
    snapshot takes one shard per device of its values' kind:
    ``torch.cuda.device_count()`` for CUDA values, 1 for host values.
    ``capacity`` is the slots a shard has for each owner (default: exact).
    """

    name = "routed"

    def __init__(self, mesh=None, axis_name: Optional[str] = None,
                 capacity: Optional[int] = None):
        dist = torch.distributed
        if mesh is None and dist.is_available() and dist.is_initialized():
            mesh = world_mesh(axis_name or "dht")
        self.mesh = mesh
        self.axis_name = axis_name or (mesh_axis_names(mesh)[0]
                                       if mesh is not None else "dht")
        self.capacity = capacity

    def _mesh_for(self, values: torch.Tensor):
        if self.mesh is not None:
            return self.mesh
        return make_mesh(torch.cuda.device_count() if values.is_cuda else 1,
                         self.axis_name)

    def snapshot(self, values, ledger=None,
                 value_bytes: Optional[int] = None) -> ShardedDHT:
        values = torch.as_tensor(values)
        return ShardedDHT(values, ledger=ledger, value_bytes=value_bytes,
                          mesh=self._mesh_for(values),
                          axis_name=self.axis_name, capacity=self.capacity)

    def __repr__(self):
        if is_device_mesh(self.mesh):
            group = axis_group(self.mesh, self.axis_name, "RoutedDht")[0]
            ranks = torch.distributed.get_process_group_ranks(group)
            return (f"RoutedDht(axis={self.axis_name!r}, ranks={ranks!r}, "
                    f"device={self.mesh.device_type!r})")
        shards = (self.mesh.shape[self.axis_name] if self.mesh is not None
                  else "per device")
        return f"RoutedDht(axis={self.axis_name!r}, shards={shards!r})"


def resolve_backend(spec, mesh=None) -> DhtBackend:
    """Map ``"local" | "routed" | DhtBackend-instance`` to a backend object;
    ``mesh`` (a ``DhtMesh`` or a ``DeviceMesh``) goes to the routed one."""
    if isinstance(spec, str):
        if spec == "local":
            return LocalDht()
        if spec == "routed":
            return RoutedDht(mesh=mesh)
        raise ValueError(
            f"unknown dht_backend {spec!r}; expected 'local', 'routed', or a "
            "DhtBackend instance")
    if isinstance(spec, DhtBackend):
        return spec
    raise TypeError(f"dht_backend must be str or DhtBackend, got {type(spec)}")
