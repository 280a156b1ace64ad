"""The flash-attention backward: the Hopper kernels dq and dk/dv, and
``FlashAttention``, the ``torch.autograd.Function`` whose forward is the
forward kernel with its ``lse`` output; the counterpart of the JAX
package's ``flash_attention/bwd.py::flash_attention_trainable``.

Two routes, chosen by input (:func:`route`), never one in place of the
other:

- ``"wgmma"`` (``csrc/flash_attention_bwd_wgmma.cu``): bf16 at head width
  64 or 128, on the tensor cores (``wgmma``, TMA, P and dS split into bf16
  hi and lo parts so they keep their f32 semantics);
- ``"simt"`` (``csrc/flash_attention_bwd.cu``): f32 at any head width, and
  bf16 at 16, 32 or 256, f32 FMAs on the CUDA cores (an f32 product on the
  tensor cores would be TF32).

On CUDA tensors the Function launches the kernels; on CPU tensors it runs
their plain versions (``ref.attention_fwd_lse_ref``,
``ref.attention_bwd_ref``), so the CPU tests exercise its plumbing; on
``meta`` tensors it returns empty outputs of the kernels' shapes (the
dry-run's branch).  There is no fallback from one to the other.  The
sources compile with ``nvcc`` on first use, as the forward's do
(``kernels/_build.py``); nothing is built or loaded when this module is
imported.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .kernel import CSRC, _check_tma, check_kernel_inputs, \
    flash_attention_cuda, tma_fault
from .ref import attention_bwd_ref, attention_flops, attention_fwd_lse_ref

# route -> (source, library, {kernel: C entry}); a route's two entries take
# the arguments of the SIMT route's entries
ROUTES = {
    "wgmma": (CSRC / "flash_attention_bwd_wgmma.cu",
              _build.BUILD_DIR / "libflash_attention_bwd_wgmma.so",
              {"dq": "flash_attention_bwd_dq_wgmma_launch",
               "dkv": "flash_attention_bwd_dkv_wgmma_launch"}),
    "simt": (CSRC / "flash_attention_bwd.cu",
             _build.BUILD_DIR / "libflash_attention_bwd.so",
             {"dq": "flash_attention_bwd_dq_launch",
              "dkv": "flash_attention_bwd_dkv_launch"}),
}
WGMMA_HEAD_DIMS = (64, 128)

_fns = {}


def route(q: torch.Tensor) -> str:
    """The backward kernels that take ``q`` (and its k, v, do): ``"wgmma"``
    for bf16 at head width 64 or 128, ``"simt"`` for everything else the
    kernels take."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def build(which: str = None, force: bool = False) -> str:
    """Compile route ``which``'s source ("wgmma" or "simt"; both when
    None) unless an up-to-date library exists; returns the compiler's log
    ("" when nothing was built).  Raises if ``nvcc`` fails."""
    return "".join(_build.build(source, library, force=force)
                   for name, (source, library, _) in ROUTES.items()
                   if which in (None, name))


def _launcher(which: str, kernel: str):
    if (which, kernel) not in _fns:
        source, library, symbols = ROUTES[which]
        n_ptrs = 7 if kernel == "dq" else 8
        _fns[which, kernel] = _build.load(
            source, library, symbols[kernel],
            [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return _fns[which, kernel]


def _call(kernel, which, ptrs, tensors, q, k, causal, window):
    """One launch of route ``which``'s ``kernel`` ("dq" or "dkv") on
    ``q``'s device and current stream; ``tensors`` give the (b, s, h)
    strides in the entry's order."""
    B, S, H, D = q.shape
    _, K, Hkv, _ = k.shape
    which = which or route(q)
    strides = (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for t in tensors for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher(which, kernel)(
            *ptrs, int(q.dtype == torch.bfloat16), B, S, K, H, Hkv, D,
            strides, int(bool(causal)), int(window), stream)
    if err:
        raise RuntimeError(f"flash_bwd_{kernel} ({which}) launch failed: "
                           f"CUDA error {err}" + (" (cuTensorMapEncodeTiled "
                           "refused a tensor map)" if err < 0 else ""))


def _check(q, k, v, do, lse, delta):
    """What the kernels need (``kernel.check_kernel_inputs``), ``do`` like
    q, and on the wgmma route the layout TMA needs of q, k, v and do;
    raises ``ValueError`` on anything else: there is no silent copy."""
    # the forward's wgmma route holds every input of this one, so
    # check_kernel_inputs has checked q, k and v for TMA already
    check_kernel_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.stride(3) != 1:
        raise ValueError("do must be like q, with a unit-stride last axis")
    if route(q) == "wgmma":
        _check_tma(do, "do")
    B, S, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, S)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 (B, H, S)")


def launch_dq(q, k, v, do, lse, delta, dq, causal, window,
              which: str = None) -> None:
    """The bare dq launch into a caller-owned ``dq`` like q; nothing when
    B, S or H is 0.  ``which`` names the route (default ``route(q)``): the
    SIMT kernel also takes what the wgmma route does, which is how
    ``chip_smoke.py`` times the two on the same inputs."""
    if q.shape[0] and q.shape[1] and q.shape[2]:
        _call("dq", which,
              [t.data_ptr() for t in (q, k, v, do, lse, delta, dq)],
              (q, k, v, do, dq), q, k, causal, window)


def launch_dkv(q, k, v, do, lse, delta, dk, dv, causal, window,
               which: str = None) -> None:
    """The bare dk/dv launch into caller-owned ``dk``, ``dv`` like k;
    nothing when B, K or Hkv is 0 (with S 0 it writes zeros).  ``which``
    as for :func:`launch_dq`."""
    if k.shape[0] and k.shape[1] and k.shape[2]:
        _call("dkv", which,
              [t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)],
              (q, k, v, do, dk, dv), q, k, causal, window)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 window: int = 0) -> torch.Tensor:
    """dq (B, S, H, D) like q, from the saved ``lse`` and ``delta`` =
    rowsum(do o), both f32 (B, H, S).  ``flash_bwd_dq.launches`` counts
    the kernel's launches, ``flash_bwd_dq.launches_by_route`` the same
    launches by route (:func:`route`)."""
    _check(q, k, v, do, lse, delta)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    launch_dq(q, k, v, do, lse, delta, dq, causal, window)
    if q.numel():
        flash_bwd_dq.launches += 1
        flash_bwd_dq.launches_by_route[route(q)] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                  window: int = 0):
    """(dk, dv) (B, K, Hkv, D) like k, each summed over the G query heads
    of its group.  ``flash_bwd_dkv.launches`` counts the kernel's
    launches, ``flash_bwd_dkv.launches_by_route`` the same by route."""
    _check(q, k, v, do, lse, delta)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    launch_dkv(q, k, v, do, lse, delta, dk, dv, causal, window)
    if k.numel():
        flash_bwd_dkv.launches += 1
        flash_bwd_dkv.launches_by_route[route(q)] += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches_by_route = {"wgmma": 0, "simt": 0}
flash_bwd_dkv.launches_by_route = {"wgmma": 0, "simt": 0}
# the kernels' work answered on meta tensors (``ref.attention_flops``)
flash_bwd_dq.meta_flops = 0
flash_bwd_dkv.meta_flops = 0


def row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do o) in f32, (B, H, S) contiguous: the plain torch
    op before the kernels, as the reference computes it in XLA."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def kernel_do(q: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``do`` as the kernels of ``route(q)`` take it: ``do`` itself, or a
    contiguous copy when its last axis is strided or, on the wgmma route,
    when TMA cannot load it (a misaligned base or (b, s, h) stride, or a
    broadcast axis).  Autograd, not the caller, chooses the layout of the
    gradient it hands :class:`FlashAttention`, so the Function copies it;
    the bare wrappers raise instead."""
    broadcast = any(n > 1 and s == 0
                    for n, s in zip(do.shape[:3], do.stride()[:3]))
    if do.stride(-1) != 1 or (route(q) == "wgmma"
                              and (broadcast or tma_fault(do, "do"))):
        return do.clone(memory_format=torch.contiguous_format)
    return do


class FlashAttention(torch.autograd.Function):
    """Attention with the kernels' backward: ``apply(q, k, v, causal,
    window)`` -> out like q.  Saves q, k, v, the output and the rows'
    log-sum-exp; the backward recomputes P from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.is_cuda:
            out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                            window=window, with_lse=True)
        elif q.device.type == "meta":
            B, S, H, _ = q.shape
            out = torch.empty_like(q, memory_format=torch.contiguous_format)
            lse = q.new_empty((B, H, S), dtype=torch.float32)
        else:
            out, lse = attention_fwd_lse_ref(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "meta":
            flash_bwd_dq.meta_flops += attention_flops(q, k, ctx.causal,
                                                       ctx.window, 3)
            flash_bwd_dkv.meta_flops += attention_flops(q, k, ctx.causal,
                                                        ctx.window, 4)
            delta = row_delta(out, do)
            del delta
            return (torch.empty_like(q, memory_format=torch.contiguous_format),
                    torch.empty_like(k, memory_format=torch.contiguous_format),
                    torch.empty_like(v, memory_format=torch.contiguous_format),
                    None, None)
        if not q.is_cuda:
            dq, dk, dv = attention_bwd_ref(q, k, v, out, lse, do, ctx.causal,
                                           ctx.window)
            return dq, dk, dv, None, None
        do = kernel_do(q, do)
        delta = row_delta(out, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.window)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                               ctx.window)
        return dq, dk, dv, None, None
