"""Distributed hash table (DHT) — the AMPC primitive, local path (torch).

The paper's DHT stores the previous round's output as key-value pairs with
integer keys known to all machines.  On one device it is a dense tensor
indexed by key, and a lookup is a gather.  This is the port of the JAX
package's ``repro.core.dht`` local path: ``dedup_keys`` (the paper's
per-machine caching, Section 5.3), ``lookup`` and ``ShardedDHT`` with two
gather implementations:

  * ``"take"`` — plain indexing after ``dedup_keys``;
  * ``"cuda"`` — the ``kernels.dht_gather`` cached-gather kernel, whose hit
    count feeds the same ledger counters.  The default on CUDA tensors.

``dedup_gather`` reads a table that trains (SASRec's item table) through
the same kernel, with a gradient (:class:`DedupGather`).

Every count a lookup produces stays on the device and goes to the ledger
through ``RoundLedger.record_queries_deferred``.  The routed (all-to-all)
backend is not ported yet (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

from typing import Tuple

import torch

INT_MAX = 2**31 - 1


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
    """Immutable DHT snapshot on one device, with uniform ledger accounting.

    Every lookup reports query / byte / dedup / overflow counters through
    the ledger, whichever gather implementation (``impl``) serves it.
    ``impl=None`` picks ``"cuda"`` for CUDA values and ``"take"`` otherwise.
    """

    backend = "local"

    def __init__(self, values: torch.Tensor, ledger=None,
                 value_bytes: int | None = None, impl: str | None = None):
        self.values = values
        self.ledger = ledger
        self._row_bytes = value_bytes or int(
            values.element_size() * (values.numel()
                                     // max(values.shape[0], 1)))
        if impl is None:
            impl = "cuda" if values.is_cuda else "take"
        if impl not in ("take", "cuda"):
            raise ValueError(f"impl must be 'take' or 'cuda', got {impl!r}")
        self.impl = impl

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
        # neither as queries nor as dedup savings.  Every count below stays
        # on the device; the ledger decides when to read it.
        ledger = self.ledger
        if keys.numel() == 0:
            if ledger is not None:
                ledger.record_queries(0, 0, waves=0)
            return torch.zeros(keys.shape + self.values.shape[1:],
                               dtype=self.values.dtype,
                               device=self.values.device)
        if dedup and self.impl == "cuda" and self.values.numel():
            valid = (keys >= 0).sum()
            out, hits = self._cuda_gather(keys)
            n_unique = valid - hits
            nbytes = n_unique * (self._row_bytes + 4)
            deduped = hits
        else:
            out, n_unique, nbytes, deduped = _fused_local_lookup(
                self.values, keys, self._row_bytes, dedup)
        if ledger is not None:
            ledger.record_queries_deferred(
                n_unique, nbytes, waves=1, deduped_away=deduped, overflow=0)
        return out
