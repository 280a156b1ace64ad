"""Build and bind the Hopper flash-attention forward kernels, which also
write each row's log-sum-exp for the backward kernels (``bwd.py``) when
asked.  Two routes, chosen by input (:func:`route`), never one in place of
the other:

- ``"wgmma"`` (``csrc/flash_attention_fwd_wgmma.cu``): bf16 at head width
  64, 128 or 256, on the tensor cores (``wgmma``, TMA, a split bf16 P that
  keeps P's f32 semantics);
- ``"simt"`` (``csrc/flash_attention_fwd.cu``): f32 at any head width, and
  bf16 at 16 or 32, f32 FMAs on the CUDA cores (an f32 product on the
  tensor cores would be TF32).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, in the repository's ``build/`` directory, on
first use; ``ctypes`` loads it (``kernels/_build.py``).  Nothing is built or
loaded when this module is imported, so the CPU tests import it freely.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

CSRC = Path(__file__).resolve().parent / "csrc"
# route -> (source, library, C entry); both entries take the same arguments
ROUTES = {
    "wgmma": (CSRC / "flash_attention_fwd_wgmma.cu",
              _build.BUILD_DIR / "libflash_attention_fwd_wgmma.so",
              "flash_attention_fwd_wgmma_launch"),
    "simt": (CSRC / "flash_attention_fwd.cu",
             _build.BUILD_DIR / "libflash_attention_fwd.so",
             "flash_attention_fwd_launch"),
}
HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)
MAX_GRID_YZ = 65535   # CUDA grid limit of the SIMT route's y (H), z (B) axes
MAX_GRID_X = 2 ** 31 - 1   # the wgmma route's one axis: query tiles x H x B
WGMMA_BQ = 128             # the wgmma route's query rows per CTA
TMA_ALIGN = 16             # bytes: TMA's base and stride granule

_fns = {}


def route(q: torch.Tensor) -> str:
    """The kernel that takes ``q`` (and its k, v): ``"wgmma"`` for bf16 at
    head width 64, 128 or 256, ``"simt"`` for everything else the kernels
    take."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def build(which: str, force: bool = False) -> str:
    """Compile route ``which``'s kernel ("wgmma" or "simt") unless an
    up-to-date library exists; returns the compiler's log ("" when nothing
    was built).  Raises if ``nvcc`` fails."""
    source, library, _ = ROUTES[which]
    return _build.build(source, library, force=force)


def _launcher(which: str):
    if which not in _fns:
        source, library, symbol = ROUTES[which]
        _fns[which] = _build.load(
            source, library, symbol,
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return _fns[which]


def tma_fault(t: torch.Tensor, name: str) -> str:
    """Why TMA cannot load a bf16 tensor of this layout, or "" when it can:
    TMA needs a 16-byte-aligned base and (b, s, h) strides of a multiple of
    16 bytes on every axis longer than 1 (an axis of size 1 is never
    stepped)."""
    es = t.element_size()
    if t.data_ptr() % TMA_ALIGN:
        return (f"{name}'s base is not {TMA_ALIGN}-byte aligned, as the "
                f"wgmma route's TMA loads need")
    for axis in range(3):
        if t.shape[axis] > 1 and (t.stride(axis) * es) % TMA_ALIGN:
            return (f"{name}'s stride {t.stride(axis)} on axis {axis} is not "
                    f"a multiple of {TMA_ALIGN} bytes, as the wgmma route's "
                    f"TMA loads need")
    return ""


def _check_tma(t: torch.Tensor, name: str) -> None:
    """Raises ``ValueError`` where :func:`tma_fault` finds a fault."""
    fault = tma_fault(t, name)
    if fault:
        raise ValueError(fault)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """What the forward and backward kernels need: q, k, v of one type
    (bf16 or f32), one batch and head width D in 16, 32, 64, 128 or 256, H
    a multiple of Hkv, each with a unit-stride last axis, and a grid that
    fits.  On the wgmma route (:func:`route`) q, k and v also need what TMA
    needs (16-byte-aligned bases, strides of a multiple of 16 bytes); on
    the SIMT route other strides are free.  Raises ``ValueError`` on
    anything else: there is no silent copy."""
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
    if route(q) == "wgmma":
        if -(-q.shape[1] // WGMMA_BQ) * H * B > MAX_GRID_X:
            raise ValueError(f"{B} x {H} x {q.shape[1]} rows pass the grid's "
                             f"{MAX_GRID_X} CTAs")
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_tma(t, name)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         with_lse: bool = False):
    """Launch the kernel of ``route(q)`` on ``q``'s device and current
    stream: out (B, S, H, D) like ``q``, and with ``with_lse`` also each
    row's log-sum-exp, f32 (B, H, S), for the backward kernels.

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
           lse: torch.Tensor = None, which: str = None) -> None:
    """The bare launch into a caller-owned ``out`` (B, S, H, D, contiguous
    rows) and, where given, ``lse`` (f32 (B, H, S), contiguous), on inputs
    that :func:`flash_attention_cuda` has checked; nothing when B, S or H
    is 0.  ``which`` names the route (default ``route(q)``): the SIMT
    kernel also takes what the wgmma route does, which is how
    ``chip_smoke.py`` times the two on the same inputs."""
    B, S, H, D = q.shape
    _, K, Hkv, _ = k.shape
    if not (B and S and H):
        return
    which = which or route(q)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher(which)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(),
                               None if lse is None else lse.data_ptr(),
                               int(q.dtype == torch.bfloat16), B,
                               S, K, H, Hkv, D, strides, int(bool(causal)),
                               int(window), stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd ({which}) launch failed: "
                           f"CUDA error {err}" + (" (cuTensorMapEncodeTiled "
                           "refused a tensor map)" if err < 0 else ""))
