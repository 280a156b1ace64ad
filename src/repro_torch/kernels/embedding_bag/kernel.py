"""Build and bind the Hopper ``embedding_bag`` kernel
(``csrc/embedding_bag.cu``).

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
from .ref import check_inputs

SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"
LIBRARY = _build.BUILD_DIR / "libembedding_bag.so"

_fn = None


def build(force: bool = False) -> str:
    """Compile the kernel unless an up-to-date library exists; returns the
    compiler's log ("" when nothing was built).  Raises if ``nvcc`` fails."""
    return _build.build(SOURCE, LIBRARY, force=force)


def _launcher():
    global _fn
    if _fn is None:
        _fn = _build.load(
            SOURCE, LIBRARY, "embedding_bag_launch",
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
    return _fn


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor):
    """Launch the kernel on ``table``'s device and current stream: (B, D)
    in the table's type.

    ``table`` (V, D) f32 or bf16 and ``ids`` (B, L) int32 lie on one CUDA
    device; non-contiguous inputs are copied.  Raises on anything else, and
    if the launch reports a CUDA error.
    """
    check_inputs(table, ids)
    if not (table.is_cuda and ids.device == table.device):
        raise ValueError("embedding_bag_cuda takes table and ids on one "
                         "CUDA device")
    table, ids = table.contiguous(), ids.contiguous()
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    launch(table, ids, out)
    return out


def launch(table: torch.Tensor, ids: torch.Tensor, out: torch.Tensor) -> None:
    """The bare launch into a caller-owned ``out`` (B, D), on contiguous
    inputs that :func:`embedding_bag_cuda` has checked; nothing when B or D
    is 0."""
    V, D = table.shape
    B, L = ids.shape
    if not (B and D):
        return
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = _launcher()(table.data_ptr(), V, D,
                          int(table.dtype == torch.bfloat16), ids.data_ptr(),
                          B, L, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err}")
