"""int8 gradient compression with error feedback, the counterpart of the
JAX package's ``optim/grad_compression.py``.

A gradient plus the feedback carried from the last step is quantized to
int8 with one f32 scale a tensor (its largest magnitude over 127, a true
division on every device), rounded half to even as ``jnp.round`` rounds;
the quantization residual becomes the next feedback (EF-SGD, Karimireddy
et al.), so SGD and Adam stay convergent.  A tree is a tensor or nested dicts and lists of tensors (the
port's name -> tensor dicts).

``compressed_psum`` is the reference's data-parallel all-reduce of the
int8 gradients under one shared scale a tensor, over a
``torch.distributed`` process group (one rank a card, NCCL; gloo on the
CPU) where the reference's runs over a ``shard_map`` axis.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..devices import axis_group


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


def _scale(corrected: torch.Tensor) -> torch.Tensor:
    """The f32 scale of a corrected gradient: its largest magnitude over
    127."""
    amax = torch.clamp(corrected.abs().max(), min=1e-12)
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python
    # scalar one, which may round otherwise than the division
    return amax / torch.full_like(amax, 127.0)


def _quantize(corrected: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(corrected / scale), -127,
                       127).to(torch.int8)


def compress(g: torch.Tensor, feedback: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale f32 scalar, new_feedback f32)."""
    corrected = g.float() + feedback
    scale = _scale(corrected)
    q = _quantize(corrected, scale)
    return q, scale, corrected - q.float() * scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, feedback):
    """Leaf-wise compression: (q tree, scale tree, new feedback tree)."""
    out = _map(compress, grads, feedback)
    return tuple(_map(lambda leaf, i=i: leaf[i], out) for i in range(3))


def decompress_tree(q, s):
    return _map(decompress, q, s)


def compressed_psum(grads, feedback, axis_name: str | None = None, *,
                    mesh=None):
    """The mean of every rank's gradients, all-reduced as int8 under one
    shared scale a tensor, and this rank's new feedback: (avg tree,
    feedback tree).

    Every rank of the group calls it with a tree of one layout.  The
    group is ``mesh``'s dimension ``axis_name`` (a ``DeviceMesh``, as the
    reference's ``axis_name`` names a ``shard_map`` axis), or the default
    group where ``mesh`` is None.  The reference's steps, in its order:
    the scales ``compress_tree`` gives; their maximum over the ranks; each
    gradient plus its feedback quantized again against that maximum
    (rounded half to even); the feedback ``g + fb - q * s_max``; the int8
    values summed over the ranks as int32; the sum dequantized and divided
    by the group's size.  Raises where ``torch.distributed`` is not
    initialized.  Leaf by leaf, so no whole tree of int32 sums or of
    ``compress_tree``'s values and feedback is held at once.
    """
    import torch.distributed as dist
    group, n, _ = axis_group(mesh, axis_name, "compressed_psum")

    def shared_scale(g, fb):
        scale = _scale(g.float() + fb)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        return scale

    s_max = _map(shared_scale, grads, feedback)
    q2 = _map(lambda g, fb, sm: _quantize(g.float() + fb, sm),
              grads, feedback, s_max)
    fb2 = _map(lambda g, fb, q, sm: g.float() + fb - q.float() * sm,
               grads, feedback, q2, s_max)

    def mean(q, sm):
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        # the group's size as a tensor divisor: CUDA multiplies by the
        # reciprocal of a Python scalar one
        return total.float() * sm / torch.full_like(sm, n)

    return _map(mean, q2, s_max), fb2
