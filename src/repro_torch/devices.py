"""The port's one rule for where its entry points run: on CUDA unless the
caller asks for another device (``"cpu"``, or ``"meta"`` to build a model
with no storage, as the dry-run does), the parameter draws that follow
it, and the process groups a run spans (one rank a card: a
``DeviceMesh`` dimension or the default group)."""
from __future__ import annotations

import torch


def resolve_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``, CUDA when it is None; raises if
    that is CUDA and no CUDA device is available.  ``what`` names the
    entry point in the message."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on CUDA and no CUDA device is "
                           f"available; pass device='cpu' to run on the host")
    return dev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a sharded tensor of
    ``torch.distributed.tensor``)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``torch.distributed`` ``DeviceMesh``."""
    if mesh is None or not torch.distributed.is_available():
        return False
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def axis_group(mesh, axis_name, what: str):
    """(group, size, rank) of one dimension of a ``DeviceMesh``: the one
    named ``axis_name``, or the only one of a 1-D mesh when ``axis_name``
    is None or the mesh names none.  ``mesh=None`` is the default group
    (group ``None``).  Raises where ``torch.distributed`` is not
    initialized; ``what`` names the caller in the message."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"{what} runs over a process group and "
                           "torch.distributed is not initialized")
    if mesh is None:
        return None, dist.get_world_size(), dist.get_rank()
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name is not None and axis_name in names:
        dim = names.index(axis_name)
    elif mesh.ndim == 1 and (axis_name is None or not names):
        dim = 0
    else:
        raise ValueError(f"{what}: the mesh has no dimension {axis_name!r} "
                         f"(its dimensions: {names})")
    return mesh.get_group(dim), mesh.size(dim), mesh.get_local_rank(dim)


def world_mesh(axis_name: str = "dht"):
    """A 1-D ``DeviceMesh`` named ``axis_name`` over every rank of the
    default process group: on ``cuda`` where the group runs NCCL, on
    ``cpu`` otherwise (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh
    dist = torch.distributed
    device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def whole(x):
    """A DTensor gathered whole on every rank of its mesh; any other value
    as it is."""
    return x.full_tensor() if is_dtensor(x) else x


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the ``meta`` device, which
    has none: :func:`randn` draws nothing from it and gives an empty
    tensor of the shape and type asked for."""
    device = torch.device("meta")


def seeded_generator(dev: torch.device, seed: int):
    """A generator on ``dev`` seeded with ``seed`` (a
    :class:`MetaGenerator` on ``meta``)."""
    if dev.type == "meta":
        return MetaGenerator()
    return torch.Generator(device=dev).manual_seed(seed)


def randn(shape, generator, dtype) -> torch.Tensor:
    """Standard normal draws of ``shape`` in ``dtype`` from ``generator``
    on its device; on ``meta`` an empty tensor, nothing drawn."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device)
