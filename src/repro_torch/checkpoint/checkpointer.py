"""Numpy-based checkpointer: atomic and resumable, the counterpart of the
JAX package's ``checkpoint/checkpointer.py``.

Layout: ``<dir>/step_<N>/`` with one ``.npy`` per leaf plus
``manifest.json``.  Writes go to a ``.tmp`` directory first and are
renamed into place, so a writer that is stopped midway never corrupts the
latest checkpoint; ``keep`` bounds how many stay.  A tree is nested dicts
and lists of tensors (leaves named by their path joined with ``__``, as
in the reference); bf16 leaves, which numpy has no type for, are stored
as their 16-bit patterns and the manifest names their type.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

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


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    """Write ``tree`` as ``step_<step>`` under ``ckpt_dir`` and keep the
    newest ``keep`` checkpoints (all when ``keep`` <= 0)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for name, leaf in _flatten(tree):
        t = torch.as_tensor(leaf).detach().cpu()
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
    return final


def _steps(ckpt_dir: str) -> List[int]:
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, tree_like: Any,
            step: Optional[int] = None) -> tuple:
    """Returns (tree, step): the checkpoint at ``step`` (the latest when
    None) laid out as ``tree_like``, each leaf with the type and device of
    its counterpart there."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        by_name = {rec["name"]: rec for rec in json.load(f)["leaves"]}
    out = []
    for name, like in _flatten(tree_like):
        rec = by_name[name]
        t = torch.from_numpy(np.load(os.path.join(d, rec["file"])))
        if rec["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        like = torch.as_tensor(like)
        out.append(t.to(dtype=like.dtype, device=like.device))
    return _unflatten(tree_like, iter(out)), step


def _cleanup(ckpt_dir: str, keep: int):
    for s in (_steps(ckpt_dir)[:-keep] if keep > 0 else []):
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
