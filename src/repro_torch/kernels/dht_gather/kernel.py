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
CHUNK_BYTES = (16, 8, 4, 2)   # the widths the kernel copies a row in

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
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p])
    return _fn


def chunk_bytes(row_bytes: int, *addresses: int) -> int:
    """The widest of 16, 8, 4 and 2 bytes that divides ``row_bytes`` and
    every address: the width of the chunks the kernel copies a row in.
    Raises when none does (a row of an odd number of bytes)."""
    for width in CHUNK_BYTES:
        if row_bytes % width == 0 and all(a % width == 0 for a in addresses):
            return width
    raise ValueError(f"no chunk width divides a row of {row_bytes} bytes "
                     f"and the addresses {addresses}")


def dht_gather_cuda(table: torch.Tensor, sorted_keys: torch.Tensor,
                    order: torch.Tensor | None = None):
    """Launch the kernel on the current stream: (out (Q, D) in the caller's
    order, hits 0-d int32).

    ``table`` is a contiguous (V, D) CUDA tensor of 2- or 4-byte elements;
    ``sorted_keys`` a contiguous (Q,) int32 CUDA tensor sorted ascending;
    ``order`` the (Q,) int64 permutation ``torch.sort`` returned with them
    (sorted key q goes to row ``order[q]`` of ``out``), or None when the
    keys came sorted.  An empty batch launches nothing.  Raises on anything
    else, and if the launch reports a CUDA error.
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
    if order is not None and (
            order.shape != sorted_keys.shape or order.dtype != torch.int64
            or not order.is_contiguous()
            or order.device != sorted_keys.device):
        raise ValueError("order must be a contiguous (Q,) int64 tensor "
                         "beside the keys")
    V, D = table.shape
    Q = sorted_keys.shape[0]
    if Q and V == 0:
        raise ValueError("cannot gather from an empty table")
    out = torch.empty((Q, D), dtype=table.dtype, device=table.device)
    hits = torch.zeros(1, dtype=torch.int32, device=table.device)
    launch(table, sorted_keys, order, out, hits)
    return out, hits.reshape(())


def launch(table: torch.Tensor, sorted_keys: torch.Tensor,
           order: torch.Tensor | None, out: torch.Tensor,
           hits: torch.Tensor) -> None:
    """The bare launch into caller-owned buffers, which
    :func:`dht_gather_cuda` checks and allocates: ``out`` (Q, D) like
    ``table``, ``hits`` one int32 the kernel adds its count to."""
    V, D = table.shape
    Q = sorted_keys.shape[0]
    if Q and D:
        row_bytes = D * table.element_size()
        width = chunk_bytes(row_bytes, table.data_ptr(), out.data_ptr())
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = _launcher()(table.data_ptr(), V, row_bytes, width,
                          sorted_keys.data_ptr(),
                          None if order is None else order.data_ptr(), Q,
                          out.data_ptr(), hits.data_ptr(), stream)
        if err:
            raise RuntimeError(f"dht_gather launch failed: CUDA error {err}")
