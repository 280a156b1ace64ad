"""``flash_attention``: the attention of the LM.

On CUDA tensors it launches the Hopper kernels (``kernel.py``, and
``bwd.py`` when a gradient is wanted); on CPU tensors it runs their plain
versions (``ref.py``); on ``meta`` tensors it returns empty outputs of the
right shapes and counts the kernels' work by formula (the dry-run's
branch: no launch, no count).  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from .bwd import FlashAttention
from .kernel import flash_attention_cuda, route
from .ref import attention_flops, attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(D) + mask) v for q (B, S, H, D) against k, v
    (B, K, Hkv, D); query head h reads kv head h // (H // Hkv).

    ``window`` is a Python ``int`` (0 or less: unbounded); a tensor window
    raises rather than being dropped.  With ``causal``, K must be at least
    S.  Where grad is enabled and an input requires it, the call goes
    through ``bwd.FlashAttention``, whose backward is the dq and dk/dv
    kernels on CUDA tensors and their plain version on CPU tensors.

    ``flash_attention.launches`` counts forward kernel launches (CUDA
    tensors), ``flash_attention.launches_by_route`` the same launches by
    the kernel that took them (``kernel.route``: "wgmma" or "simt");
    ``bwd.flash_bwd_dq.launches`` and ``bwd.flash_bwd_dkv.launches`` count
    the backward kernels', and their ``launches_by_route`` the same by
    ``bwd.route`` (bf16 at D 64/128 on "wgmma", the rest on "simt").  On
    ``meta`` tensors nothing launches or counts; ``meta_flops`` of each
    of the three adds the kernel's ``ref.attention_flops`` instead (the
    forward at each call, a recomputed one too; dq and dk/dv at the
    backward).
    """
    # the contract on every device; flash_attention_cuda checks what the
    # kernel itself needs (type, head width, strides)
    if isinstance(window, bool) or not isinstance(window, int):
        raise TypeError(f"window must be a Python int, got "
                        f"{type(window).__name__}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, S, H, D) and k, v (B, K, Hkv, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if causal and k.shape[1] < q.shape[1]:
        raise ValueError(f"causal attention with K {k.shape[1]} < S "
                         f"{q.shape[1]} leaves the first queries without a "
                         f"key")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on the same device")
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"flash_attention runs on CUDA, CPU or meta "
                         f"tensors, got {q.device}")
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    if q.device.type == "meta":
        flash_attention.meta_flops += attention_flops(q, k, causal, window, 2)
    if grad:
        out = FlashAttention.apply(q, k, v, causal, window)
    elif q.device.type == "meta":
        return torch.empty_like(q, memory_format=torch.contiguous_format)
    elif q.is_cuda:
        out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    else:
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.is_cuda and q.numel():   # an empty q launches nothing
        flash_attention.launches += 1
        flash_attention.launches_by_route[route(q)] += 1
    return out


flash_attention.launches = 0
flash_attention.meta_flops = 0
flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}
