"""The port's one rule for where its entry points run: on CUDA unless the
caller asks for another device."""
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
