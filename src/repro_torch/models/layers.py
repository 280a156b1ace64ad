"""Shared transformer building blocks, as plain functions on tensors
(parameters are dicts of tensors).

The JAX package's ``models/layers.py`` for the dense LM:
  * RMSNorm scaled by (1 + scale), computed in f32
  * RoPE on split halves (not interleaved)
  * GQA attention with f32 logits and softmax (``attention_xla``), and its
    chunked form with an online softmax over KV chunks
    (``attention_xla_chunked``), O(S chunk) memory instead of O(S^2)
  * q/k/v projection with optional bias and qk-norm, SwiGLU MLP
Parameters are cast to the activation's type at use.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..devices import randn

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


def attention_decode_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, hd_block: slice, reduce_hd,
                           reduce_seq=None):
    """One decode token's attention against one rank's block of the KV
    cache: ``attention_xla`` with the cache split over head_dim and, for
    a single long stream, over its slots.

    q (b, 1, H, hd) is whole (qk-norm and RoPE, which pair dimension i
    with i + hd/2, are applied before); k and v (b, S_l, Hkv, hd_l) are
    the rank's block, ``hd_block`` the slice of head_dim it holds; mask
    (b, 1, S_l) its slots'.  The scores are partial sums over head_dim
    blocks, which ``reduce_hd(t)`` all-reduces.  Where ``reduce_seq(t,
    op)`` is given the slots are split: a split-K softmax, the row maxima
    and sums reduced by it, then the p·v partials.  Returns (b, 1, H,
    hd_l), this rank's head_dim block of the output."""
    b, Q, H, D = q.shape
    Hkv = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf = q[..., hd_block].float().reshape(b, Q, Hkv, H // Hkv, -1)
    logits = reduce_hd(torch.einsum("bqhgd,bkhd->bhgqk", qf,
                                    k.float())) * scale
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    if reduce_seq is None:
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    else:
        top = reduce_seq(logits.amax(-1, keepdim=True), "max")
        p = torch.exp(logits - top)
        total = reduce_seq(p.sum(-1), "sum")                # (b, Hkv, G, Q)
        out = reduce_seq(torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()),
                         "sum") / total.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, Q, H, -1).to(q.dtype)


# q chunks that one KV step of the chunked attention takes at once: as many
# as keep its (B, n, Hkv, G, cq, ck) f32 logits within this many elements
# (1 GiB)
Q_GROUP_ELEMENTS = 1 << 28


def _chunks(S: int, K: int, chunk_q: int, chunk_kv: int):
    cq, ck = min(chunk_q, S), min(chunk_kv, K)
    if S % cq or K % ck:
        raise ValueError(f"chunked attention needs S {S} and K {K} to be "
                         f"multiples of their chunks {cq} and {ck}")
    return cq, ck


def _online_softmax_step(carry, logits, vc, p_bf16: bool):
    """One KV chunk of the online softmax: ``logits`` (..., cq, ck) f32,
    already masked; ``vc`` (B, ck, Hkv, D); ``carry`` (m, l, acc) with acc
    (..., cq, D), all f32.  The reference's arithmetic in its order."""
    m, l, acc = carry
    m_new = torch.maximum(m, logits.amax(-1))
    p = torch.exp(logits - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    # p's leading dims: B, [q chunks,] Hkv, G; vc's: B, ck, Hkv
    eq = ("bnhgqk,bkhd->bnhgqd" if p.dim() == 6 else "bhgqk,bkhd->bhgqd")
    if p_bf16:
        pv = torch.einsum(eq, p.to(torch.bfloat16),
                          vc.to(torch.bfloat16)).float()
    else:
        pv = torch.einsum(eq, p, vc.float())
    return m_new, l_new, acc * corr[..., None] + pv


def _checkpointed(fn, *args):
    """``fn(*args)`` under activation checkpointing where autograd records
    (the reference's ``jax.checkpoint`` of each KV step): the step's
    (..., cq, ck) logits are recomputed in the backward instead of kept."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def attention_xla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_pos: torch.Tensor, k_pos: torch.Tensor,
                          window: Optional[int] = None, causal: bool = True,
                          chunk_q: int = 512, chunk_kv: int = 512,
                          softmax_scale: Optional[float] = None,
                          p_bf16: bool = False,
                          static_positions: bool = False,
                          static_window: Optional[int] = None):
    """Flash-style chunked attention in plain torch: an online softmax
    over KV chunks, in f32 as ``attention_xla`` computes, O(S chunk)
    memory.  q: (B, S, H, D); k/v: (B, K, Hkv, D); q_pos (B, S), k_pos
    (B, K).  ``window`` <= 0 or None is unbounded.  S and K must be
    multiples of their chunks (``min(chunk, S)``, ``min(chunk, K)``).

    Each q chunk scans every KV chunk, as the reference's ``lax.map`` over
    q chunks does; the port takes up to ``Q_GROUP_ELEMENTS``' worth of q
    chunks in one KV step, which changes no q chunk's arithmetic.  Each KV
    step runs under activation checkpointing when autograd records.

    ``static_positions=True`` asserts q_pos/k_pos are standard aranges (q
    aligned to the end of k), enabling static causal chunk skipping: each
    q chunk scans only the KV chunks that meet its causal prefix, and with
    a uniform ``static_window`` not the leading out-of-window ones.

    On ``meta`` tensors without autograd (the dry-run's prefill) it runs
    one KV step's allocations instead of the loop and adds the loop's
    product FLOPs to ``attention_xla_chunked.meta_flops``: the loop is
    some 10^5 steps a prefill_32k cell."""
    if q.device.type == "meta" and not (
            torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return _chunked_on_meta(q, k, window, causal, chunk_q, chunk_kv,
                                static_positions and causal, static_window)
    if static_positions and causal:
        return _attention_chunked_skipping(
            q, k, v, window, chunk_q, chunk_kv, softmax_scale, p_bf16,
            static_window)
    B, S, H, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    cq, ck = _chunks(S, K, chunk_q, chunk_kv)
    nq, nk = S // cq, K // ck
    qr = q.reshape(B, nq, cq, Hkv, G, D)
    qp = q_pos.reshape(B, nq, cq)
    group = max(1, min(nq, Q_GROUP_ELEMENTS // (B * H * cq * ck)))

    def kv_step(qf, qpc, m, l, acc, kc, vc, kpc):
        logits = torch.einsum("bnqhgd,bkhd->bnhgqk", qf, kc.float()) * scale
        diff = qpc - kpc[:, None, None, None, None, :]
        mask = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
        if causal:
            mask &= diff >= 0
        if window is not None and window > 0:
            mask &= diff < window
        logits = torch.where(mask, logits, NEG_INF)
        return _online_softmax_step((m, l, acc), logits, vc, p_bf16)

    outs = []
    for q0 in range(0, nq, group):
        n = min(group, nq - q0)
        qf = qr[:, q0:q0 + n].float()                  # (B, n, cq, Hkv, G, D)
        qpc = qp[:, q0:q0 + n, None, None, :, None]    # (B, n, 1, 1, cq, 1)
        m = torch.full((B, n, Hkv, G, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, n, Hkv, G, cq, D), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            part = slice(j * ck, (j + 1) * ck)
            m, l, acc = _checkpointed(kv_step, qf, qpc, m, l, acc,
                                      k[:, part], v[:, part],
                                      k_pos[:, part])
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        # (B, n, Hkv, G, cq, D) -> (B, n, cq, Hkv, G, D)
        outs.append(out.permute(0, 1, 4, 2, 3, 5).reshape(B, n * cq, H, D)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def _chunked_on_meta(q, k, window, causal, chunk_q, chunk_kv, skipping,
                     static_window):
    """The chunked attention's output on ``meta``, its two products
    (4·cq·ck·D a head and block visited) counted, and one KV step's f32
    buffers (logits, probabilities, the running state) allocated and freed
    so a memory tracker sees the step's peak."""
    B, S, H, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    cq, ck = _chunks(S, K, chunk_q, chunk_kv)
    nq, nk = S // cq, K // ck
    if skipping:
        blocks, group = 0, 1
        for qi in range(nq):
            q_start = qi * cq + K - S
            hi = min(nk, (q_start + cq - 1) // ck + 1)
            lo = (max(0, (q_start - static_window + 1) // ck)
                  if static_window and static_window > 0 else 0)
            blocks += hi - lo
    else:
        blocks = nq * nk
        group = max(1, min(nq, Q_GROUP_ELEMENTS // (B * H * cq * ck)))
    attention_xla_chunked.meta_flops += 4 * B * H * cq * ck * D * blocks
    state = q.new_empty((B, group, Hkv, H // Hkv, cq, D + 2),
                        dtype=torch.float32)
    logits = q.new_empty((B, group, Hkv, H // Hkv, cq, ck),
                         dtype=torch.float32)
    probs = torch.empty_like(logits)
    del state, logits, probs
    return torch.empty_like(q, memory_format=torch.contiguous_format)


attention_xla_chunked.meta_flops = 0


def _attention_chunked_skipping(q, k, v, window, chunk_q: int, chunk_kv: int,
                                softmax_scale, p_bf16: bool,
                                static_window: Optional[int]):
    """Causal chunked attention with static KV-range skipping: each q
    chunk (unrolled) scans only KV chunks [lo, hi), hi the causal bound
    and lo the window bound when the window is a static uniform int.
    ``window`` still masks inside the diagonal blocks (gemma3's mixed
    local:global layers).  Queries sit at the end of the keys
    (q_offset = K - S)."""
    B, S, H, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    cq, ck = _chunks(S, K, chunk_q, chunk_kv)
    nq, nk = S // cq, K // ck
    q_offset = K - S
    qr = q.reshape(B, nq, cq, Hkv, G, D)
    rows = torch.arange(cq, dtype=torch.int32, device=q.device)[:, None]
    cols = torch.arange(ck, dtype=torch.int32, device=q.device)[None, :]

    def kv_step(qf, q_start, m, l, acc, kc, vc, k_start):
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc.float()) * scale
        diff = (q_start + rows) - (k_start + cols)
        mask = diff >= 0
        if window is not None and window > 0:
            mask &= diff < window
        logits = torch.where(mask, logits, NEG_INF)
        return _online_softmax_step((m, l, acc), logits, vc, p_bf16)

    outs = []
    for qi in range(nq):
        q_start = qi * cq + q_offset
        hi = min(nk, (q_start + cq - 1) // ck + 1)          # causal bound
        lo = 0
        if static_window and static_window > 0:
            lo = max(0, (q_start - static_window + 1) // ck)
        qf = qr[:, qi].float()                           # (B, cq, Hkv, G, D)
        m = torch.full((B, Hkv, G, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, cq, D), dtype=torch.float32,
                          device=q.device)
        for j in range(lo, hi):
            part = slice(j * ck, (j + 1) * ck)
            m, l, acc = _checkpointed(kv_step, qf, q_start, m, l, acc,
                                      k[:, part], v[:, part], j * ck)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, cq, H, D)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


@dataclasses.dataclass(frozen=True)
class AttnParamsSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool
    qk_norm: bool


def _normal(generator: torch.Generator, shape, dtype, scale: float):
    return randn(shape, generator, dtype) * float(scale)


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
    q, k, v = attn_project(params, x, spec)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attn_project(params, x: torch.Tensor, spec: AttnParamsSpec,
                 heads_cs=None, products=None):
    """q (B, S, H, hd), k and v (B, S, Hkv, hd) before RoPE: the
    projections, their biases and the qk-norm.  ``products(x, [wq, wk,
    wv])`` gives the three products (``x @ w`` each when None; a sharded
    layer's runs on each rank's weight blocks); every other op has a
    DTensor rule.  ``heads_cs(t, heads)`` (a sharding context's
    constraint) places each (B, S, heads·hd) projection before it splits
    into heads, identity when None."""
    B, S, _ = x.shape
    H, Hkv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    ws = [params["wq"], params["wk"], params["wv"]]
    if products is None:
        q, k, v = (x @ w.to(x.dtype) for w in ws)
    else:
        q, k, v = products(x, ws)
    if spec.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if heads_cs is not None:
        q, k, v = heads_cs(q, H), heads_cs(k, Hkv), heads_cs(v, Hkv)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
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
    """SwiGLU: :func:`mlp_swiglu_block` with the whole d and no
    reductions."""
    return mlp_swiglu_block(params, x)


def mlp_swiglu_block(params, x: torch.Tensor, sctx=None, d_axes=(),
                     f_axes=(), reduce_f: bool = True):
    """SwiGLU with the weights as one rank's (d, f) blocks and ``x``
    (..., d_l) the rank's block of d (whole where ``d_axes`` is empty):
    gate and up are partial over the d blocks, all-reduced over ``d_axes``
    (``sctx.reduce``); the SiLU product runs on the f block, its gradient
    a partial sum over the d blocks (``sctx.reduce_grad``); down is
    partial over the f blocks, all-reduced over ``f_axes`` unless
    ``reduce_f`` is False (the caller reduces it).  Returns the rank's d
    block of the output.  Without ``sctx``, the plain SwiGLU."""
    g = x @ params["w_gate"].to(x.dtype)
    u = x @ params["w_up"].to(x.dtype)
    if sctx is not None:
        g, u = sctx.reduce(g, d_axes), sctx.reduce(u, d_axes)
    h = F.silu(g) * u
    if sctx is not None:
        h = sctx.reduce_grad(h, d_axes)
    y = h @ params["w_down"].to(x.dtype)
    return sctx.reduce(y, f_axes) if sctx is not None and reduce_f else y
