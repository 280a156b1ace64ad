"""Build and bind the Hopper ``segment_matmul`` kernel
(``csrc/segment_matmul.cu``), which also writes the f32 neighbour sum for
the backward when asked.

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_matmul.cu"
LIBRARY = _build.BUILD_DIR / "libsegment_matmul.so"
DTYPES = (torch.float32, torch.bfloat16)
MAX_K = 1024          # the kernel's MAX_K: nbr slots staged in shared memory
MAX_F = 64 * 65535    # 64 output columns for each CTA of the grid's y axis

_fn = None


def build(force: bool = False) -> str:
    """Compile the kernel unless an up-to-date library exists; returns the
    compiler's log ("" when nothing was built).  Raises if ``nvcc`` fails."""
    return _build.build(SOURCE, LIBRARY, force=force)


def _launcher():
    global _fn
    if _fn is None:
        _fn = _build.load(
            SOURCE, LIBRARY, "segment_matmul_launch",
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return _fn


def load_width(D: int, elem_bytes: int, x_address: int,
               agg_address: int | None = None) -> int:
    """Elements of an x row the kernel loads at once: 2 (8-byte f32 or
    4-byte bf16 pairs) where D is even, x's address a multiple of two
    elements and agg's of 8 bytes; else 1."""
    if D % 2 or x_address % (2 * elem_bytes):
        return 1
    if agg_address is not None and agg_address % 8:
        return 1
    return 2


def segment_matmul_cuda(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                        with_agg: bool = False):
    """Launch the kernel on ``x``'s device and current stream: out (M, F)
    in x's type and, with ``with_agg``, also the f32 neighbour sum (M, D).

    ``x`` (N, D) and ``w`` (D, F) are CUDA tensors of one type (f32 or
    bf16), ``nbr`` (M, K) int32 on the same device with K <= ``MAX_K``;
    non-contiguous inputs are copied.  Raises on anything else, and if the
    launch reports a CUDA error.
    """
    check_inputs(x, nbr, w)
    if not (x.is_cuda and nbr.device == x.device and w.device == x.device):
        raise ValueError("segment_matmul_cuda takes x, nbr and w on one "
                         "CUDA device")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be f32 or both bf16, got "
                         f"{x.dtype} and {w.dtype}")
    if nbr.shape[1] > MAX_K:
        raise ValueError(f"nbr has {nbr.shape[1]} slots a row; the kernel "
                         f"stages at most {MAX_K}")
    if w.shape[1] > MAX_F:
        raise ValueError(f"F {w.shape[1]} > {MAX_F}")
    x, nbr, w = x.contiguous(), nbr.contiguous(), w.contiguous()
    M, F = nbr.shape[0], w.shape[1]
    out = torch.empty((M, F), dtype=x.dtype, device=x.device)
    agg = None
    if with_agg:
        agg = torch.empty((M, x.shape[1]), dtype=torch.float32,
                          device=x.device)
    launch(x, nbr, w, out, agg)
    return (out, agg) if with_agg else out


def launch(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
           out: torch.Tensor, agg: torch.Tensor = None) -> None:
    """The bare launch into a caller-owned ``out`` (M, F) and, where given,
    ``agg`` (f32 (M, D)), on contiguous inputs that
    :func:`segment_matmul_cuda` has checked; nothing when M or F is 0."""
    N, D = x.shape
    M, K = nbr.shape
    F = w.shape[1]
    if not (M and F):
        return
    vec = load_width(D, x.element_size(), x.data_ptr(),
                     None if agg is None else agg.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(x.data_ptr(), N, D, nbr.data_ptr(), M, K,
                          w.data_ptr(), F, out.data_ptr(),
                          None if agg is None else agg.data_ptr(),
                          int(x.dtype == torch.bfloat16), vec, stream)
    if err:
        raise RuntimeError(f"segment_matmul launch failed: CUDA error {err}")
