"""Build and bind the Hopper ``dht_gather`` kernel (``csrc/dht_gather.cu``).

The source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, in the repository's ``build/`` directory, on first
use; ``ctypes`` loads it (``kernels/_build.py``).  Nothing is built or
loaded when this module is imported, so the CPU tests import it freely.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "dht_gather.cu"
LIBRARY = _build.BUILD_DIR / "libdht_gather.so"

_fn = None


def build(force: bool = False) -> str:
    """Compile the kernel unless an up-to-date library exists; returns the
    compiler's log ("" when nothing was built).  Raises if ``nvcc`` fails."""
    return _build.build(SOURCE, LIBRARY, force=force)


def _launcher():
    global _fn
    if _fn is None:
        _fn = _build.load(
            SOURCE, LIBRARY, "dht_gather_launch",
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    return _fn


def dht_gather_cuda(table: torch.Tensor, sorted_keys: torch.Tensor):
    """Launch the kernel on the current stream: (out (Q, D), hits 0-d int32).

    ``table`` is a contiguous (V, D) CUDA tensor of 2- or 4-byte elements;
    ``sorted_keys`` a contiguous (Q,) int32 CUDA tensor sorted ascending.
    An empty batch launches nothing.  Raises on anything else, and if the
    launch reports a CUDA error.
    """
    if not (table.is_cuda and sorted_keys.is_cuda):
        raise ValueError("dht_gather_cuda takes CUDA tensors")
    if table.device != sorted_keys.device:
        raise ValueError("table and keys must be on the same device")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous (V, D) tensor")
    if table.element_size() not in (2, 4):
        raise ValueError(f"dht_gather copies 2- or 4-byte elements, got "
                         f"{table.dtype}")
    if (sorted_keys.dim() != 1 or sorted_keys.dtype != torch.int32
            or not sorted_keys.is_contiguous()):
        raise ValueError("keys must be a contiguous (Q,) int32 tensor")
    V, D = table.shape
    Q = sorted_keys.shape[0]
    if Q and V == 0:
        raise ValueError("cannot gather from an empty table")
    out = torch.empty((Q, D), dtype=table.dtype, device=table.device)
    hits = torch.zeros(1, dtype=torch.int32, device=table.device)
    launch(table, sorted_keys, out, hits)
    return out, hits.reshape(())


def launch(table: torch.Tensor, sorted_keys: torch.Tensor,
           out: torch.Tensor, hits: torch.Tensor) -> None:
    """The bare launch into caller-owned buffers, which
    :func:`dht_gather_cuda` checks and allocates: ``out`` (Q, D) like
    ``table``, ``hits`` one int32 the kernel adds its count to."""
    V, D = table.shape
    Q = sorted_keys.shape[0]
    if Q and D:
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = _launcher()(table.data_ptr(), V, D, table.element_size(),
                          sorted_keys.data_ptr(), Q, out.data_ptr(),
                          hits.data_ptr(), stream)
        if err:
            raise RuntimeError(f"dht_gather launch failed: CUDA error {err}")
