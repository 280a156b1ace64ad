"""What the loops share: the run's record, device helpers and the
comparison of per-leaf norms."""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class Record:
    """One run: the end-to-end readings of its window, what it attempted
    and failed, its peak device memory, its traced stretch (or None), and
    each number compared with its limit."""
    setup_s: float
    metrics: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[object]
    checks: Dict[str, dict]


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def release(device: torch.device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def finite(x: float) -> float:
    """A reading as JSON can carry it: a non-finite one as 1e300, which no
    limit admits."""
    return x if math.isfinite(x) else 1e300


def check(value: float, limit: float) -> dict:
    return {"value": finite(float(value)), "limit": limit}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   names=None) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    names = list(want) if names is None else list(names)
    med = statistics.median(want[n] for n in names)
    return worst(abs(got[n] - want[n]) / max(want[n], med) for n in names)


def worst(values) -> float:
    """The largest of ``values``; infinite where any is not finite."""
    values = list(values)
    if not all(math.isfinite(v) for v in values):
        return math.inf
    return max(values)
