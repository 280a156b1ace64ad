"""The port's one rule for where its entry points run: on CUDA unless the
caller asks for another device (``"cpu"``, or ``"meta"`` to build a model
with no storage, as the dry-run does), and the parameter draws that
follow it."""
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
