"""The traced stretch of a run: ``torch.profiler`` over a few steps of the
window's own loop, reduced to what the per-layer metrics read.

``Recorder`` traces two stretches, one after the other.  The first records
the device's activity alone (no host ops), so that the profiler costs the
host as little as it can: its window runs from the start of a marker
kernel launched right after a synchronize to the end of one launched after
the last step, and the device's operations (kernels, copies, fills) inside
it give the busy time as the length of their union; every per-layer
metric and the breakdown's ``device_ops`` read it.  The second, one step
with host ops recorded too, serves only to name the breakdown's idle gaps
by what the host was doing.  The per-layer readers
(``perfbench/metrics/<name>.py``) get a ``Trace``.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10


@dataclasses.dataclass
class Trace:
    """A traced stretch of ``steps`` steps of a cell's loop, and the rest of
    the run's window after it, untraced: ``after_steps`` steps launched in
    ``after_s`` seconds of the host's clock, ended by a synchronize."""
    ops: List[Tuple[str, float, float]]     # device (name, start s, end s)
    host: List[Tuple[str, float, float]]    # host ops, same clock
    window: Tuple[float, float]             # the stretch, same clock
    steps: int
    config: dict
    mix: dict
    after_steps: int = 0
    after_s: float = 0.0
    gaps_from: Optional["Trace"] = None     # the stretch that names idle gaps

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self):
        """(name, seconds) of every kernel launched in the stretch (no
        copies or fills)."""
        return [(n, e - s) for n, s, e in self.ops
                if not n.startswith(("Memcpy", "Memset"))]

    def busy_intervals(self):
        """The union of the device's operations inside the window, as
        sorted disjoint (start, end)."""
        w0, w1 = self.window
        merged = []
        for _, s, e in sorted((o for o in self.ops), key=lambda o: o[1]):
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_ops(self) -> List[list]:
        """The device operations that took most time, summed by name."""
        by = {}
        for n, s, e in self.ops:
            by[n[:120]] = by.get(n[:120], 0.0) + (e - s)
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:TOP]]

    def idle_gaps(self) -> List[list]:
        """The longest idle gaps of the device inside the window, each named
        by the innermost host op running where it starts (of ``gaps_from``
        where there is one)."""
        if self.gaps_from is not None:
            return self.gaps_from.idle_gaps()
        w0, w1 = self.window
        gaps, at = [], w0
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if w1 > at:
            gaps.append((at, w1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = []
        for g0, g1 in gaps:
            i = bisect.bisect_right(starts, g0)
            best = None
            for name, s, e in host[max(0, i - 2000):i]:
                if e >= g0 and (best is None or s >= best[1]):
                    best = (name, s)
            out.append([best[0][:120] if best else "(no host op)", g1 - g0])
        return out


class Recorder:
    """Profiles ``steps`` calls of a loop's step on the card (``run``):
    one call first with the profiler on and outside the window, so that the
    profiler's own start-up stays out of it, then a synchronize and the
    window, device activity only; then one more call with host ops
    recorded too, for the idle gaps' names."""

    def __init__(self, device: torch.device):
        if device.type != "cuda":
            raise ValueError("the traced stretch needs a CUDA device")
        self.device = device
        self.stretches = []

    def _stretch(self, step, steps: int, host: bool, warm: bool):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if host:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        prof = torch.profiler.profile(activities=acts, record_shapes=False)
        prof.start()
        if warm:
            step()
        torch.cuda.synchronize(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            step()
        end.record()
        torch.cuda.synchronize(self.device)
        prof.stop()
        self.stretches.append((prof, start.elapsed_time(end) / 1e3, steps))

    def run(self, step, steps: int):
        self._stretch(step, steps, host=False, warm=True)
        self._stretch(step, 1, host=True, warm=False)

    def trace(self, config: dict, mix: dict, after_steps: int,
              after_s: float) -> Trace:
        (device, n), (host, one) = (
            (_events(p, s), k) for p, s, k in self.stretches)
        return Trace(*device, n, config, mix, after_steps, after_s,
                     gaps_from=Trace(*host, one, config, mix))


def _events(prof, window_s: float):
    """(device ops, host ops, window) of a stretch, in seconds of the
    profiler's clock: the window is ``window_s`` long and ends where the
    last device operation ends."""
    ops, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        span = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        if getattr(e, "is_user_annotation", False):
            continue
        (ops if e.device_type == cuda else host).append(span)
    if not ops:
        raise RuntimeError("the profiler kept no device operation")
    last = max(o[2] for o in ops)
    window = (last - window_s, last)
    ops = [o for o in ops if o[2] > window[0]]
    host = [h for h in host if h[2] >= window[0]]
    return ops, host, window


def breakdown(trace: Trace) -> Dict[str, list]:
    return {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}


def read_metrics(trace: Optional[Trace], readers: Dict[str, object]
                 ) -> Dict[str, float]:
    """Each reader's value; a reader that finds nothing returns None and
    its metric is left out."""
    out = {}
    for name, reader in readers.items():
        value = reader.read(trace)
        if value is not None:
            out[name] = float(value)
    return out
