"""Round / query / byte accounting for AMPC executions (torch port).

The same ledger model as the JAX package's ``repro.core.rounds``: a
"shuffle" is a materialized round; adaptive in-round query waves count
queries and DHT bytes but not shuffles.  A ledger may carry a ``tracer``
and a ``metrics`` registry (``repro_torch.obs``).

Two accounting modes, as in the reference.  A ledger created with
``deferred=True`` queues DHT traffic records whose scalars may still be
device tensors, and :meth:`RoundLedger.harvest` brings every pending
record, together with the solver's output tensors, to the host in **one**
device-to-host copy per solve (:func:`harvest_many`: one per
``solve_many`` bucket, for all its ledgers); the engine builds its ledgers
so.  A bare ``RoundLedger()`` keeps ``deferred=False``: every record is
applied when it is made, in one copy, so its counters can be read right
after the lookup that produced them, and a harvest copies its ``extra``
leaf by leaf (the eager baseline).  The
copies both modes make are counted in :data:`TRANSFERS`.  Scalar counters
are int64 on the device, so the byte counters the reference computes as
int32 products cannot wrap here.

The reference runs its fixpoints as single device programs; the port's
eager loops read their loop condition on the host once per wave instead.
Those reads are counted in :data:`HOST_READS` (not in solver stats, which
must stay equal to the reference's).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

# Test hook for the one-harvest-per-solve rule: when set, called with the
# ledger each time a harvest performs its single device-to-host transfer.
HARVEST_HOOK: Any = None

# Host reads made by the eager fixpoint loops to decide whether to run
# another wave (see :func:`host_read` / :func:`active_lanes`).
HOST_READS = 0

# Device-to-host copies made for the accounting: a harvest's one copy
# (eager: one a leaf), an eager record's one copy, and the two reads of an
# eager local lookup (``core.dht``).  See :func:`to_host`.
TRANSFERS = 0


def host_read(x: torch.Tensor):
    """Copy one device scalar to the host for a loop condition (counted)."""
    global HOST_READS
    HOST_READS += 1
    return x.item()


def active_lanes(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the ``True`` lanes: a host read of the mask's count."""
    global HOST_READS
    HOST_READS += 1
    return torch.nonzero(mask).squeeze(1)


class DeviceCounters:
    """Pending DHT-traffic records for one ledger.

    Each record is five scalars (queries, nbytes, waves, deduped_away,
    overflow), any of which may still be a device tensor, plus the tracer
    span open at record time.  :meth:`RoundLedger.harvest` drains them.
    """

    __slots__ = ("records",)

    def __init__(self):
        self.records: List = []

    def add(self, record, span=None) -> None:
        self.records.append((record, span))

    def drain(self) -> List:
        records, self.records = self.records, []
        return records

    def __len__(self):
        return len(self.records)

    def __repr__(self):
        return f"DeviceCounters(pending={len(self.records)})"


def to_host(leaves):
    """Copy a list of leaves to the host in one transfer (counted in
    :data:`TRANSFERS`).

    Tensor leaves (all on one device) are packed as raw bytes into one
    buffer and copied with a single ``.cpu()``; other leaves pass through.
    Returns numpy arrays (0-d for scalars) in leaf order.
    """
    global TRANSFERS
    out = list(leaves)
    idx = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    if not idx:
        return out
    TRANSFERS += 1
    tensors = [leaves[i].detach().contiguous() for i in idx]
    host = torch.cat([t.reshape(-1).view(torch.uint8)
                      for t in tensors]).cpu().numpy()
    off = 0
    for i, t in zip(idx, tensors):
        nb = t.numel() * t.element_size()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[i] = host[off:off + nb].view(dtype).reshape(tuple(t.shape))
        off += nb
    return out


@dataclasses.dataclass
class RoundLedger:
    algorithm: str = ""
    shuffles: int = 0
    bytes_shuffled: int = 0
    dht_queries: int = 0
    dht_bytes: int = 0
    dht_query_waves: int = 0
    dedup_savings: int = 0  # queries avoided by the caching optimization
    dht_overflows: int = 0  # routed-router capacity overflows (0 = exact)
    wall_time_s: float = 0.0
    phase_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    events: List[str] = dataclasses.field(default_factory=list)
    # observability hooks (repro_torch.obs); None => disabled
    tracer: Any = dataclasses.field(repr=False, compare=False, default=None)
    metrics: Any = dataclasses.field(repr=False, compare=False, default=None)
    record_events: bool = dataclasses.field(compare=False, default=True)
    # deferred accounting: queue device scalars, harvest once per solve
    deferred: bool = dataclasses.field(compare=False, default=False)
    device: DeviceCounters = dataclasses.field(
        repr=False, compare=False, default_factory=DeviceCounters)

    # -- shuffle (materialized round) -------------------------------------
    @contextlib.contextmanager
    def shuffle(self, name: str, nbytes: int = 0):
        tracer = self.tracer
        t0 = time.perf_counter()
        if tracer is not None and tracer.enabled:
            with tracer.span(f"shuffle:{name}", algorithm=self.algorithm,
                             nbytes=int(nbytes)):
                yield
        else:
            yield
        self._count_shuffle(name, nbytes, time.perf_counter() - t0)

    def record_shuffle(self, name: str, nbytes: int = 0,
                       seconds: float = 0.0):
        """Record one materialized round without timing a ``with`` block.

        Used by batched (``solve_many``) launches, where one physical launch
        serves many per-graph ledgers: each ledger records its own shuffle
        entry with its share of the bytes and wall time.  With a tracer the
        share becomes a retroactive span under the current open span.
        """
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.record_span(f"shuffle:{name}", dur_s=seconds,
                               algorithm=self.algorithm, nbytes=int(nbytes))
        self._count_shuffle(name, nbytes, seconds)

    def _count_shuffle(self, name: str, nbytes: int, seconds: float):
        self.shuffles += 1
        self.bytes_shuffled += int(nbytes)
        self.wall_time_s += seconds
        self.phase_times[name] = self.phase_times.get(name, 0.0) + seconds
        if self.record_events:
            self.events.append(f"shuffle:{name}:{nbytes}B:{seconds:.4f}s")
        if self.metrics is not None:
            self.metrics.counter(
                "shuffles_total", labelnames=("algorithm",)).inc(
                    1, algorithm=self.algorithm)
            self.metrics.counter(
                "bytes_shuffled_total", labelnames=("algorithm",)).inc(
                    int(nbytes), algorithm=self.algorithm)

    # -- DHT traffic -------------------------------------------------------
    def record_queries(self, n_queries: int, nbytes: int, waves: int = 1,
                       deduped_away: int = 0, overflow: int = 0):
        """Eagerly record one wave of DHT traffic (host values)."""
        self._apply_queries(int(n_queries), int(nbytes), int(waves),
                            int(deduped_away), int(overflow))

    def record_queries_deferred(self, n_queries, nbytes, waves=1,
                                deduped_away=0, overflow=0):
        """Record DHT traffic without leaving the device.

        Arguments may be device tensors.  On a ``deferred=True`` ledger
        they are queued untouched and materialized by :meth:`harvest`.  On
        an eager ledger the record is applied now, in one transfer, so the
        counters can be read right after the lookup that produced them.
        """
        record = (n_queries, nbytes, waves, deduped_away, overflow)
        if not self.deferred:
            self._apply_queries(*(int(x) for x in to_host(list(record))))
            return
        span = None
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            span = tracer.current_span()
        self.device.add(record, span)

    def harvest(self, extra=None):
        """Materialize every pending record (and ``extra``) in one transfer.

        ``extra`` is a tensor or a tuple of tensors / host values the
        caller wants on the host (solver outputs, counters); its host copy
        is returned with numpy arrays in place of tensors.  This is the
        *one* device-to-host copy a solve makes: :data:`HARVEST_HOOK`
        fires once per harvest.  With nothing pending and no ``extra`` the
        call is free.

        On an eager (``deferred=False``) ledger the records were applied
        when they were made, and ``extra`` is copied leaf by leaf, one
        transfer each: the eager baseline, not a half-deferred hybrid.
        """
        records = self.device.drain()
        if not records and extra is None:
            return None
        if HARVEST_HOOK is not None:
            HARVEST_HOOK(self)
        single = extra is not None and not isinstance(extra, (tuple, list))
        leaves = [] if extra is None else ([extra] if single else list(extra))
        if not self.deferred and extra is not None:
            host = [to_host([leaf])[0] for leaf in leaves]
            return host[0] if single else tuple(host)
        flat = [x for rec, _ in records for x in rec]
        host_all = to_host(flat + leaves)
        host = host_all[len(flat):]
        for k, (_, span) in enumerate(records):
            self._apply_queries(
                *(int(x) for x in host_all[5 * k:5 * k + 5]), span=span)
        if extra is None:
            return None
        return host[0] if single else tuple(host)

    def _apply_queries(self, n_queries: int, nbytes: int, waves: int,
                       deduped_away: int, overflow: int, span=None):
        """Fold one wave of host-side counts into counters/trace/metrics."""
        self.dht_queries += n_queries
        self.dht_bytes += nbytes
        self.dht_query_waves += waves
        self.dedup_savings += deduped_away
        self.dht_overflows += overflow
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            kw = dict(queries=n_queries, nbytes=nbytes, waves=waves,
                      deduped_away=deduped_away, overflow=overflow)
            if span is not None:
                span.event("dht_queries", **kw)
            else:
                tracer.event("dht_queries", **kw)
        m = self.metrics
        if m is not None:
            labels = {"labelnames": ("algorithm",)}
            kw = {"algorithm": self.algorithm}
            m.counter("dht_queries_total", **labels).inc(n_queries, **kw)
            m.counter("dht_bytes_total", **labels).inc(nbytes, **kw)
            m.counter("dht_query_waves_total", **labels).inc(waves, **kw)
            if deduped_away:
                m.counter("dedup_savings_total", **labels).inc(
                    deduped_away, **kw)
            if overflow:
                m.counter("dht_overflows_total", **labels).inc(
                    overflow, **kw)

    def summary(self) -> Dict:
        if self.device.records:  # safety net: a forgotten harvest
            self.harvest()
        return {
            "algorithm": self.algorithm,
            "shuffles": self.shuffles,
            "bytes_shuffled": self.bytes_shuffled,
            "dht_queries": self.dht_queries,
            "dht_bytes": self.dht_bytes,
            "dht_query_waves": self.dht_query_waves,
            "dedup_savings": self.dedup_savings,
            "dht_overflows": self.dht_overflows,
            "wall_time_s": round(self.wall_time_s, 4),
            "phase_times": {k: round(v, 4)
                            for k, v in self.phase_times.items()},
        }


def _flatten(tree, leaves):
    """Append ``tree``'s leaves (tuples and lists nest) to ``leaves``;
    returns a function that rebuilds the tree from an iterator."""
    if isinstance(tree, (tuple, list)):
        builds = [_flatten(x, leaves) for x in tree]
        kind = type(tree)
        return lambda it: kind(b(it) for b in builds)
    leaves.append(tree)
    return lambda it: next(it)


def harvest_many(ledgers: Sequence[Optional[RoundLedger]], extra=None):
    """Harvest several ledgers in one device-to-host transfer.

    The ``solve_many`` counterpart of :meth:`RoundLedger.harvest`: one
    bucket launch queues records on every per-graph ledger, and the
    engine drains them all, plus the batched outputs in ``extra`` (a
    tensor, or tuples/lists of tensors, host values and ``None``), with a
    single copy.  :data:`HARVEST_HOOK` fires once, with the ledger list.
    Returns ``extra``'s host copy, numpy arrays in place of tensors.  A
    bucket of eager ledgers copies ``extra`` leaf by leaf instead (see
    :meth:`RoundLedger.harvest`).
    """
    ledgers = [led for led in ledgers if led is not None]
    pending = [led.device.drain() for led in ledgers]
    if not any(pending) and extra is None:
        return None
    if HARVEST_HOOK is not None:
        HARVEST_HOOK(ledgers)
    leaves: List = []
    rebuild = _flatten(extra, leaves)
    if not any(pending) and not any(led.deferred for led in ledgers):
        return rebuild(iter([to_host([leaf])[0] for leaf in leaves]))
    flat = [x for records in pending for rec, _ in records for x in rec]
    host_all = to_host(flat + leaves)
    k = 0
    for led, records in zip(ledgers, pending):
        for _, span in records:
            led._apply_queries(*(int(x) for x in host_all[k:k + 5]),
                               span=span)
            k += 5
    return rebuild(iter(host_all[len(flat):]))


def nbytes_of(*arrays) -> int:
    """Total bytes of numpy arrays and tensors (``None`` entries skipped)."""
    total = 0
    for a in arrays:
        if a is None:
            continue
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        else:
            total += a.size * np.dtype(a.dtype).itemsize
    return int(total)
