"""``flash_attention``: the attention of the LM.

On CUDA tensors it launches the Hopper kernels (``kernel.py``, and
``bwd.py`` when a gradient is wanted); on CPU tensors it runs their plain
versions (``ref.py``).  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from .bwd import FlashAttention
from .kernel import flash_attention_cuda, route
from .ref import attention_ref


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
    the backward kernels'.
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
    if not q.is_cuda and q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = FlashAttention.apply(q, k, v, causal, window)
    elif q.is_cuda:
        out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    else:
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.is_cuda and q.numel():   # an empty q launches nothing
        flash_attention.launches += 1
        flash_attention.launches_by_route[route(q)] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}
