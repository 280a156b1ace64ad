"""Build and bind the Hopper flash-attention forward kernel
(``csrc/flash_attention_fwd.cu``), which also writes each row's
log-sum-exp for the backward kernels (``bwd.py``) when asked.

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_fwd.cu"
LIBRARY = _build.BUILD_DIR / "libflash_attention_fwd.so"
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)
MAX_GRID_YZ = 65535   # CUDA grid limit of the head (y) and batch (z) axes

_fn = None


def build(force: bool = False) -> str:
    """Compile the kernel unless an up-to-date library exists; returns the
    compiler's log ("" when nothing was built).  Raises if ``nvcc`` fails."""
    return _build.build(SOURCE, LIBRARY, force=force)


def _launcher():
    global _fn
    if _fn is None:
        _fn = _build.load(
            SOURCE, LIBRARY, "flash_attention_fwd_launch",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return _fn


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """What the forward and backward kernels need: q, k, v of one type
    (bf16 or f32), one batch and head width D in 16, 32, 64, 128 or 256, H
    a multiple of Hkv, each with a unit-stride last axis (other strides are
    free), and a grid that fits.  Raises on anything else."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must all be bf16 or all f32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("q and k/v differ in batch or head width")
    if D not in HEAD_DIMS:
        raise ValueError(f"head width {D} not in {HEAD_DIMS}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if H > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"the grid's y (H {H}) and z (B {B}) axes hold at "
                         f"most {MAX_GRID_YZ}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a unit-stride last axis")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         with_lse: bool = False):
    """Launch the kernel on ``q``'s device and current stream: out
    (B, S, H, D) like ``q``, and with ``with_lse`` also each row's
    log-sum-exp, f32 (B, H, S), for the backward kernels.

    ``ops.flash_attention`` checks the contract (shapes, one device, an
    ``int`` window, K >= S when ``causal``); this checks what the kernel
    needs (:func:`check_kernel_inputs`).  Raises if the launch reports a
    CUDA error.
    """
    check_kernel_inputs(q, k, v)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if not with_lse:
        launch(q, k, v, out, causal, window)
        return out
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    launch(q, k, v, out, causal, window, lse)
    return out, lse


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, window: int,
           lse: torch.Tensor = None) -> None:
    """The bare launch into a caller-owned ``out`` (B, S, H, D) and, where
    given, ``lse`` (f32 (B, H, S), contiguous), on inputs that
    :func:`flash_attention_cuda` has checked; nothing when B, S or H is
    0."""
    B, S, H, D = q.shape
    _, K, Hkv, _ = k.shape
    if not (B and S and H):
        return
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(),
                          None if lse is None else lse.data_ptr(),
                          int(q.dtype == torch.bfloat16), B,
                          S, K, H, Hkv, D, strides, int(bool(causal)),
                          int(window), stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
