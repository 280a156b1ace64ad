"""The rule that turns a sharding spec into DTensor placements, shared by
the models (``models.transformer.ShardCtx``) and the launch layer
(``launch.sharding``).

A *spec* has one entry a tensor dimension, as a ``PartitionSpec`` does:
an axis name, a tuple of axis names, or None.  Its placements have one
entry a mesh dimension: ``Shard(d)`` on every mesh dimension whose axis
shards tensor dimension d, ``Replicate()`` elsewhere.  A tensor
dimension over ("pod", "data") is ``Shard(d)`` on both, pod first, which
is JAX's row-major order.  An axis that does not divide its dimension
falls back to replicated (:func:`fix_divisibility`).

A mesh here is a ``DeviceMesh`` or anything with a ``shape`` mapping axis
names to sizes (``launch.mesh.MeshShape``, when only sizes are reckoned).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

Spec = Tuple[Any, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, mesh.shape))


def axis_size(mesh, axis) -> int:
    """The number of devices ``axis`` (a name, a tuple of names, or None)
    spans on ``mesh``."""
    sizes = mesh_axes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def fix_divisibility(spec: Spec, shape, mesh) -> Spec:
    """``spec`` with every axis that does not divide its dimension
    dropped (that dimension replicated), cut to the tensor's rank."""
    fixed = []
    for i, axis in enumerate(spec):
        if axis is None or i >= len(shape):
            fixed.append(None)
        elif shape[i] % axis_size(mesh, axis) == 0:
            fixed.append(axis)
        else:
            fixed.append(None)
    return tuple(fixed)


def placements(spec: Spec, mesh) -> tuple:
    """One DTensor placement a mesh dimension for ``spec``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_axes(mesh):
        dims = [d for d, axis in enumerate(spec) if axis == name
                or (isinstance(axis, (tuple, list)) and name in axis)]
        if len(dims) > 1:
            raise ValueError(f"axis {name!r} shards dimensions {dims}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)
