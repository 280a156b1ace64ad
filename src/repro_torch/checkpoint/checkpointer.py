"""Numpy-based checkpointer: atomic and resumable, the counterpart of the
JAX package's ``checkpoint/checkpointer.py``.

Layout: ``<dir>/step_<N>/`` with one ``.npy`` per leaf plus
``manifest.json``.  Writes go to a ``.tmp`` directory first and are
renamed into place, so a writer that is stopped midway never corrupts the
latest checkpoint; ``keep`` bounds how many stay.  A tree is nested dicts
and lists of tensors (leaves named by their path joined with ``__``, as
in the reference); bf16 leaves, which numpy has no type for, are stored
as their 16-bit patterns and the manifest names their type.

Mesh-elastic: a DTensor leaf is saved whole (every rank of its mesh
gathers it, leaf by leaf; rank 0 of the process group keeps a host copy
and writes, and all ranks wait for the commit), and
``restore(shardings=)`` puts each leaf onto the target placements, so a
checkpoint written on one mesh restores onto any other.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..devices import whole


def _flatten(tree, prefix=()) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _flatten(tree[k],
                                                        prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, t in enumerate(tree)
                for leaf in _flatten(t, prefix + (str(i),))]
    return [("__".join(prefix) or "leaf", tree)]


def _unflatten(tree, leaves):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, leaves) for t in tree)
    return next(leaves)


def _distributed() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def wait_for_ranks() -> None:
    """A barrier over the process group, where there is one."""
    if _distributed():
        torch.distributed.barrier()


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    """Write ``tree`` as ``step_<step>`` under ``ckpt_dir`` and keep the
    newest ``keep`` checkpoints (all when ``keep`` <= 0).  Under a process
    group every rank calls it: each gathers its DTensor leaves one at a
    time (a collective), rank 0 alone copies them to the host and
    writes."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    dist = _distributed()
    writer = not dist or torch.distributed.get_rank() == 0
    leaves = []
    for name, leaf in _flatten(tree):
        full = whole(leaf)
        if writer:
            leaves.append((name, torch.as_tensor(full).detach().cpu()))
        del full
    if writer:
        _write(ckpt_dir, step, final, leaves, keep)
    if dist:
        wait_for_ranks()
    return final


def _write(ckpt_dir, step, final, leaves, keep):
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for name, t in leaves:
        dtype = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.numpy()
        fn = f"{len(manifest['leaves']):05d}_{name[:80]}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({"name": name, "file": fn, "dtype": dtype,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # the commit: all or nothing
    _cleanup(ckpt_dir, keep)


def _steps(ckpt_dir: str) -> List[int]:
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None,
            shardings: Any = None) -> tuple:
    """Returns (tree, step): the checkpoint at ``step`` (the latest when
    None) laid out as ``tree_like``, each leaf with the type and device of
    its counterpart there.  ``shardings``, a tree congruent with
    ``tree_like`` of ``launch.sharding.Sharding`` (or None) leaves, puts
    each leaf onto its mesh with its placements (``distribute_tensor``):
    the elastic restart onto a mesh other than the writer's."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        by_name = {rec["name"]: rec for rec in json.load(f)["leaves"]}
    likes = _flatten(tree_like)
    targets = (check_shardings(tree_like, shardings) if shardings is not None
               else [None] * len(likes))
    out = []
    for (name, like), sh in zip(likes, targets):
        rec = by_name[name]
        t = torch.from_numpy(np.load(os.path.join(d, rec["file"])))
        if rec["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        if not isinstance(like, torch.Tensor):
            like = torch.as_tensor(like)
        t = t.to(dtype=like.dtype, device=like.device)
        out.append(t if sh is None else sh.distribute(t))
    return _unflatten(tree_like, iter(out)), step


def check_shardings(tree_like: Any, shardings: Any) -> list:
    """``shardings``' leaves in ``tree_like``'s leaf order; raises
    ``TypeError`` unless it is a tree of the same paths whose leaves are
    ``Sharding`` or None."""
    from ..launch.sharding import Sharding
    names = [name for name, _ in _flatten(tree_like)]
    flat = dict(_flatten(shardings))
    if set(flat) != set(names):
        raise TypeError(f"shardings name {sorted(flat)}, the state "
                        f"{sorted(names)}")
    bad = {n: type(s).__name__ for n, s in flat.items()
           if s is not None and not isinstance(s, Sharding)}
    if bad:
        raise TypeError(f"shardings' leaves must be Sharding or None: {bad}")
    return [flat[name] for name in names]


def _cleanup(ckpt_dir: str, keep: int):
    for s in (_steps(ckpt_dir)[:-keep] if keep > 0 else []):
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
