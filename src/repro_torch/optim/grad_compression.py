"""int8 gradient compression with error feedback, the counterpart of the
JAX package's ``optim/grad_compression.py``.

A gradient plus the feedback carried from the last step is quantized to
int8 with one f32 scale a tensor (its largest magnitude over 127, a true
division on every device), rounded half to even as ``jnp.round`` rounds;
the quantization residual becomes the next feedback (EF-SGD, Karimireddy
et al.), so SGD and Adam stay convergent.  A tree is a tensor or nested dicts and lists of tensors (the
port's name -> tensor dicts).

``compressed_psum``, the reference's all-reduce of the int8 gradients
across data-parallel devices, needs a process group: it is ROADMAP queue
1, item 12, and raises.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

_COLLECTIVES = "multi-card collectives (ROADMAP queue 1, item 12)"


def _map(fn, *trees):
    """``fn`` on the leaves of trees of one layout (dicts and lists)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [_map(fn, *leaves) for leaves in zip(*trees)]
    return fn(*trees)


def init_feedback(params) -> Any:
    """Zero f32 feedback like each leaf, on its device."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def compress(g: torch.Tensor, feedback: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale f32 scalar, new_feedback f32)."""
    corrected = g.float() + feedback
    amax = torch.clamp(corrected.abs().max(), min=1e-12)
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python
    # scalar one, which may round otherwise than the division
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    return q, scale, corrected - q.float() * scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, feedback):
    """Leaf-wise compression: (q tree, scale tree, new feedback tree)."""
    out = _map(compress, grads, feedback)
    return tuple(_map(lambda leaf, i=i: leaf[i], out) for i in range(3))


def decompress_tree(q, s):
    return _map(decompress, q, s)


def compressed_psum(grads, feedback, axis_name: str):
    """The reference's data-parallel all-reduce of int8 gradients under a
    shared scale; not ported."""
    raise NotImplementedError(f"compressed_psum all-reduces across "
                              f"devices: {_COLLECTIVES}")
