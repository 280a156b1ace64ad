"""Shared transformer building blocks, as plain functions on tensors
(parameters are dicts of tensors).

The JAX package's ``models/layers.py`` for the dense LM forward:
  * RMSNorm scaled by (1 + scale), computed in f32
  * RoPE on split halves (not interleaved)
  * GQA attention with f32 logits and softmax (``attention_xla``)
  * q/k/v projection with optional bias and qk-norm, SwiGLU MLP
Parameters are cast to the activation's type at use.  The chunked XLA
attention (``attention_xla_chunked``) is not ported yet (ROADMAP queue 1,
LM serving).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0):
    """x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions[..., None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def make_attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: Optional[int] = None, causal: bool = True):
    """(..., Q, K) boolean mask. window: <=0 or None means unbounded."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    mask = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        mask &= diff >= 0
    if window is not None and window > 0:
        mask &= diff < window
    return mask


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor, softmax_scale: Optional[float] = None):
    """q: (B, Q, H, D); k/v: (B, K, Hkv, D); mask: broadcastable to
    (B, Hkv, G, Q, K).  GQA: H % Hkv == 0.  Returns (B, Q, H, D)."""
    B, Q, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Q, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    while mask.dim() < 5:
        mask = mask[None]
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Q, H, D).to(q.dtype)


@dataclasses.dataclass(frozen=True)
class AttnParamsSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool
    qk_norm: bool


def _normal(generator: torch.Generator, shape, dtype, scale: float):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device) * float(scale)


def init_attn(generator: torch.Generator, spec: AttnParamsSpec,
              dtype=torch.float32):
    """The reference's shapes and scales, drawn from ``generator`` (on its
    device)."""
    d, H, Hkv, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    s = 1.0 / np.sqrt(d)
    p = {
        "wq": _normal(generator, (d, H * hd), dtype, s),
        "wk": _normal(generator, (d, Hkv * hd), dtype, s),
        "wv": _normal(generator, (d, Hkv * hd), dtype, s),
        "wo": _normal(generator, (H * hd, d), dtype, 1.0 / np.sqrt(H * hd)),
    }
    zeros = dict(dtype=dtype, device=generator.device)
    if spec.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), **zeros)
        p["bk"] = torch.zeros((Hkv * hd,), **zeros)
        p["bv"] = torch.zeros((Hkv * hd,), **zeros)
    if spec.qk_norm:
        p["q_norm"] = torch.zeros((hd,), **zeros)
        p["k_norm"] = torch.zeros((hd,), **zeros)
    return p


def attn_qkv(params, x: torch.Tensor, spec: AttnParamsSpec,
             positions: torch.Tensor, rope_theta: float):
    """Project to rotated q, k, v. x: (B, S, d)."""
    B, S, _ = x.shape
    H, Hkv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if spec.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32):
    s_in = 1.0 / np.sqrt(d_model)
    s_out = 1.0 / np.sqrt(d_ff)
    return {
        "w_gate": _normal(generator, (d_model, d_ff), dtype, s_in),
        "w_up": _normal(generator, (d_model, d_ff), dtype, s_in),
        "w_down": _normal(generator, (d_ff, d_model), dtype, s_out),
    }


def mlp_swiglu(params, x: torch.Tensor):
    g = F.silu(x @ params["w_gate"].to(x.dtype))
    u = x @ params["w_up"].to(x.dtype)
    return (g * u) @ params["w_down"].to(x.dtype)
