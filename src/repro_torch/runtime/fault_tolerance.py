"""Fault-tolerant training runner and straggler-aware work dispatch, the
counterpart of the JAX package's ``runtime/fault_tolerance.py``.

  * step-level checkpoints (atomic, keep-N; ``checkpoint/checkpointer.py``)
    with resume from the latest;
  * a preemption simulator: ``run(crash_at_step=n)`` raises before step n,
    and a second ``run`` resumes after the last checkpoint;
  * deterministic data: a step's batch is a pure function of (seed, step),
    so a restart needs no data state;
  * straggler mitigation at the dispatch level: the work is cut into more
    chunks than workers, and a chunk whose owner misses its deadline is
    re-issued to an idle worker (at-least-once execution of idempotent
    chunks; the consumer dedups by chunk id).

A state is a tree of dicts and lists of tensors, as the checkpointer
stores it; a restored leaf takes the type and device of its counterpart
in a fresh ``init_state_fn()``, and with ``shardings`` its placements on
a mesh (the elastic restart).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set

from ..checkpoint import checkpointer as ckpt


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 10
    keep: int = 3
    max_steps: int = 100


class TrainRunner:
    """Drives (state, step) -> state with checkpoint and restart.

    ``shardings``, a tree like the state of ``launch.sharding.Sharding``
    (or None) leaves, places a restored state over a device mesh
    (``checkpointer.restore(shardings=)``); it is checked against the
    first state, and an ill-formed one raises ``TypeError``."""

    def __init__(self, cfg: RunnerConfig, init_state_fn: Callable[[], dict],
                 step_fn: Callable[[dict, int], dict], shardings=None):
        self.cfg = cfg
        self.init_state_fn = init_state_fn
        self.step_fn = step_fn
        self.shardings = shardings

    def run(self, crash_at_step: Optional[int] = None) -> dict:
        """Steps [start, max_steps) from the latest checkpoint (or a fresh
        state), a checkpoint every ``ckpt_every`` steps and after the last;
        raises ``RuntimeError`` before step ``crash_at_step``."""
        state = self.init_state_fn()
        if self.shardings is not None:
            ckpt.check_shardings(state, self.shardings)
        start = 0
        latest = ckpt.latest_step(self.cfg.ckpt_dir)
        # under a process group rank 0 writes the checkpoints: every rank
        # reads the directory before any rank runs a step, and restores
        # the step it read
        ckpt.wait_for_ranks()
        if latest is not None:
            state, start = ckpt.restore(self.cfg.ckpt_dir, state,
                                        step=latest,
                                        shardings=self.shardings)
            start += 1
        for step in range(start, self.cfg.max_steps):
            if crash_at_step is not None and step == crash_at_step:
                raise RuntimeError(f"simulated preemption at step {step}")
            state = self.step_fn(state, step)
            if (step + 1) % self.cfg.ckpt_every == 0 or \
                    step == self.cfg.max_steps - 1:
                ckpt.save(self.cfg.ckpt_dir, step, state, keep=self.cfg.keep)
        return state


# --------------------------------------------------------------------------
# Straggler-aware chunk dispatch (host-side scheduling model)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Chunk:
    chunk_id: int
    owner: int
    issued_at: float
    done: bool = False


class StragglerDispatcher:
    """Over-decomposed work assignment with deadline-based re-issue.

    ``n_chunks`` should be a small multiple of ``n_workers`` (the paper's
    balls-into-bins argument, Lemma 8.4 of [19], bounds per-machine load).
    Chunks are idempotent: duplicated execution is deduped by chunk id.
    """

    def __init__(self, n_chunks: int, n_workers: int, deadline_s: float):
        self.n_workers = n_workers
        self.deadline = deadline_s
        self.pending: List[int] = list(range(n_chunks))
        self.inflight: Dict[int, Chunk] = {}
        self.completed: Set[int] = set()
        self.reissues = 0

    def assign(self, worker: int,
               now: Optional[float] = None) -> Optional[int]:
        now = time.monotonic() if now is None else now
        # re-issue chunks whose owner blew the deadline (straggler)
        for c in list(self.inflight.values()):
            if not c.done and now - c.issued_at > self.deadline:
                del self.inflight[c.chunk_id]
                self.pending.append(c.chunk_id)
                self.reissues += 1
        if not self.pending:
            return None
        cid = self.pending.pop(0)
        self.inflight[cid] = Chunk(cid, worker, now)
        return cid

    def complete(self, chunk_id: int) -> bool:
        """Returns True if this completion is the first (not a dup)."""
        first = chunk_id not in self.completed
        self.completed.add(chunk_id)
        self.inflight.pop(chunk_id, None)
        return first

    @property
    def all_done(self) -> bool:
        return not self.pending and all(
            c.chunk_id in self.completed for c in self.inflight.values()) \
            and len(self.completed) > 0
