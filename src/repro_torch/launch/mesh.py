"""Production meshes, the counterpart of the JAX package's
``launch/mesh.py``.

A :class:`MeshShape` names a mesh's axes and their sizes and holds no
devices: single pod 16x16 = 256 chips ("data", "model"); multi-pod 2x16x16
= 512 chips ("pod", "data", "model"), data parallel across pods and tensor
parallel inside.  The dry-run reckons per-device bytes under those
placements from the shape alone, without 256 processes.  :func:`make_mesh`
builds a real ``torch.distributed`` ``DeviceMesh`` of a shape once a
process group exists.  :func:`data_axes` and :func:`n_chips` take either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from ..placement import mesh_axes


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis sizes and names, row-major as ``jax.make_mesh`` lays them."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.sizes)} sizes for "
                             f"{len(self.axis_names)} axis names")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def __str__(self) -> str:
        return "x".join(str(s) for s in self.sizes)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_mesh(shape: MeshShape, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the current process group (one
    rank a device; ``torch.distributed`` must be initialized with
    ``prod(shape.sizes)`` ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape.sizes),
                            mesh_dim_names=tuple(shape.axis_names))


def data_axes(mesh) -> tuple:
    """The batch-sharding axes for this mesh (pod folded into data)."""
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def n_chips(mesh) -> int:
    return math.prod(mesh_axes(mesh).values())
