"""The flash-attention backward: the Hopper kernels of
``csrc/flash_attention_bwd.cu`` (dq, and dk/dv), and ``FlashAttention``,
the ``torch.autograd.Function`` whose forward is the forward kernel with its
``lse`` output; the counterpart of the JAX package's
``flash_attention/bwd.py::flash_attention_trainable``.

On CUDA tensors the Function launches the kernels; on CPU tensors it runs
their plain versions (``ref.attention_fwd_lse_ref``,
``ref.attention_bwd_ref``), so the CPU tests exercise its plumbing.  There
is no fallback from one to the other.  The source compiles with ``nvcc``
on first use, as the forward's does (``kernels/_build.py``); nothing is
built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .kernel import check_kernel_inputs, flash_attention_cuda
from .ref import attention_bwd_ref, attention_fwd_lse_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"
LIBRARY = _build.BUILD_DIR / "libflash_attention_bwd.so"

_fns = {}


def build(force: bool = False) -> str:
    """Compile both kernels unless an up-to-date library exists; returns the
    compiler's log ("" when nothing was built).  Raises if ``nvcc`` fails."""
    return _build.build(SOURCE, LIBRARY, force=force)


def _launcher(name: str, n_ptrs: int):
    if name not in _fns:
        _fns[name] = _build.load(
            SOURCE, LIBRARY, name,
            [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return _fns[name]


def _call(name, ptrs, tensors, q, k, causal, window):
    """One launch of the C entry ``name`` on ``q``'s device and current
    stream; ``tensors`` give the (b, s, h) strides in the entry's order."""
    B, S, H, D = q.shape
    _, K, Hkv, _ = k.shape
    strides = (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for t in tensors for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher(name, len(ptrs))(
            *ptrs, int(q.dtype == torch.bfloat16), B, S, K, H, Hkv, D,
            strides, int(bool(causal)), int(window), stream)
    if err:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def _check(q, k, v, do, lse, delta):
    check_kernel_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.stride(3) != 1:
        raise ValueError("do must be like q, with a unit-stride last axis")
    B, S, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, S)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 (B, H, S)")


def launch_dq(q, k, v, do, lse, delta, dq, causal, window) -> None:
    """The bare dq launch into a caller-owned ``dq`` like q; nothing when
    B, S or H is 0."""
    if q.shape[0] and q.shape[1] and q.shape[2]:
        _call("flash_attention_bwd_dq_launch",
              [t.data_ptr() for t in (q, k, v, do, lse, delta, dq)],
              (q, k, v, do, dq), q, k, causal, window)


def launch_dkv(q, k, v, do, lse, delta, dk, dv, causal, window) -> None:
    """The bare dk/dv launch into caller-owned ``dk``, ``dv`` like k;
    nothing when B, K or Hkv is 0 (with S 0 it writes zeros)."""
    if k.shape[0] and k.shape[1] and k.shape[2]:
        _call("flash_attention_bwd_dkv_launch",
              [t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)],
              (q, k, v, do, dk, dv), q, k, causal, window)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 window: int = 0) -> torch.Tensor:
    """dq (B, S, H, D) like q, from the saved ``lse`` and ``delta`` =
    rowsum(do o), both f32 (B, H, S).  ``flash_bwd_dq.launches`` counts
    the kernel's launches."""
    _check(q, k, v, do, lse, delta)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    launch_dq(q, k, v, do, lse, delta, dq, causal, window)
    if q.numel():
        flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                  window: int = 0):
    """(dk, dv) (B, K, Hkv, D) like k, each summed over the G query heads
    of its group.  ``flash_bwd_dkv.launches`` counts the kernel's
    launches."""
    _check(q, k, v, do, lse, delta)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    launch_dkv(q, k, v, do, lse, delta, dk, dv, causal, window)
    if k.numel():
        flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do o) in f32, (B, H, S) contiguous: the plain torch
    op before the kernels, as the reference computes it in XLA."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttention(torch.autograd.Function):
    """Attention with the kernels' backward: ``apply(q, k, v, causal,
    window)`` -> out like q.  Saves q, k, v, the output and the rows'
    log-sum-exp; the backward recomputes P from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.is_cuda:
            out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                            window=window, with_lse=True)
        else:
            out, lse = attention_fwd_lse_ref(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if not q.is_cuda:
            dq, dk, dv = attention_bwd_ref(q, k, v, out, lse, do, ctx.causal,
                                           ctx.window)
            return dq, dk, dv, None, None
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = row_delta(out, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.window)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                               ctx.window)
        return dq, dk, dv, None, None
