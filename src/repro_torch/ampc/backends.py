"""DHT backends for the port's AMPC engine.

The paper's AMPC model has one shared primitive: an immutable distributed
hash table written by the previous round and queried adaptively inside the
current one.  A backend binds a value tensor and a ledger into a
``core.dht.ShardedDHT`` snapshot, and every query goes through
``ShardedDHT.lookup`` — the single accounting choke point.

Only the ``local`` backend is ported; ``routed`` (the all-to-all router)
and the batched ``lookup_many`` wait for ROADMAP queue 1, items 9 and 8.
"""
from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import torch

from ..core.dht import ShardedDHT


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


class _BackendBase:
    def lookup(self, values, keys, *, ledger=None, dedup: bool = True,
               value_bytes: Optional[int] = None):
        return self.snapshot(values, ledger=ledger,
                             value_bytes=value_bytes).lookup(keys, dedup=dedup)


class LocalDht(_BackendBase):
    """Gather-based DHT on the values' own device."""

    name = "local"

    def snapshot(self, values, ledger=None,
                 value_bytes: Optional[int] = None) -> ShardedDHT:
        return ShardedDHT(torch.as_tensor(values), ledger=ledger,
                          value_bytes=value_bytes)

    def __repr__(self):
        return "LocalDht()"


def resolve_backend(spec) -> DhtBackend:
    """Map ``"local" | DhtBackend-instance`` to a backend object."""
    if isinstance(spec, str):
        if spec == "local":
            return LocalDht()
        if spec == "routed":
            raise NotImplementedError(
                "dht_backend='routed' is not ported to repro_torch yet "
                "(ROADMAP.md queue 1, item 9)")
        raise ValueError(
            f"unknown dht_backend {spec!r}; expected 'local' or a "
            "DhtBackend instance")
    if isinstance(spec, DhtBackend):
        return spec
    raise TypeError(f"dht_backend must be str or DhtBackend, got {type(spec)}")
