"""``flash_attention``: the attention of the LM forward.

On CUDA tensors it launches the Hopper kernel (``kernel.py``); on CPU
tensors it runs the plain version (``ref.py``).  There is no fallback from
one to the other.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(D) + mask) v for q (B, S, H, D) against k, v
    (B, K, Hkv, D); query head h reads kv head h // (H // Hkv).

    ``window`` is a Python ``int`` (0 or less: unbounded); a tensor window
    raises rather than being dropped.  With ``causal``, K must be at least
    S.  A CUDA call whose inputs require grad raises: the kernel has no
    backward yet.

    ``flash_attention.launches`` counts kernel launches (CUDA tensors).
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
    if q.is_cuda:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "flash_attention has no backward kernel yet: training on "
                "CUDA waits for the training slice (ROADMAP queue 1, "
                "item 1); call it under torch.no_grad()")
        out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        if q.numel():   # an empty q launches nothing
            flash_attention.launches += 1
        return out
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                     f"{q.device}")


flash_attention.launches = 0
