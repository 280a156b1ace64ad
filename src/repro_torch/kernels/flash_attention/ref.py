"""Plain PyTorch flash attention (GQA, causal, optional window): the
function the CUDA kernel computes, written out with whole-row softmax.

The same arithmetic as the JAX package's ``flash_attention/ref.py``:
inputs cast to f32, logits scaled by 1/sqrt(D), masked logits -1e30, output
cast back to q's type.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  softmax_scale=None) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, K, Hkv, D). window<=0 => unbounded.

    Query i sits at position i + K - S, so the last query lines up with
    the last key."""
    B, S, H, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(K, device=q.device)[None, :]
    diff = (qpos + (K - S)) - kpos
    mask = torch.ones((S, K), dtype=torch.bool, device=q.device)
    if causal:
        mask &= diff >= 0
    if window and window > 0:
        mask &= diff < window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
