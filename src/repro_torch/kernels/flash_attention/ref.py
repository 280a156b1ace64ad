"""Plain PyTorch flash attention (GQA, causal, optional window): the
functions the CUDA kernels compute, written out with whole-row softmax.

The same arithmetic as the JAX package's ``flash_attention/ref.py`` and
``bwd.py``: inputs cast to f32, logits scaled by 1/sqrt(D), masked logits
-1e30, outputs cast back to the inputs' types.  ``grad_limit`` is the
per-element limit by which a kernel's gradients are held against these.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
F32_ULP = 2.0 ** -24      # unit roundoff of f32
RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -14}


def _mask(S: int, K: int, causal: bool, window: int, device):
    """(S, K) keep-mask; query i sits at position i + K - S."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(K, device=device)[None, :]
    diff = (qpos + (K - S)) - kpos
    mask = torch.ones((S, K), dtype=torch.bool, device=device)
    if causal:
        mask &= diff >= 0
    if window and window > 0:
        mask &= diff < window
    return mask


def _logits(q, k, causal, window, scale):
    """Masked, scaled f32 logits (B, Hkv, G, S, K) and q as f32 (B, S,
    Hkv, G, D)."""
    B, S, H, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, S, Hkv, H // Hkv, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    logits = torch.where(_mask(S, K, causal, window, q.device), logits,
                         NEG_INF)
    return logits, qf


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  softmax_scale=None) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, K, Hkv, D). window<=0 => unbounded.

    Query i sits at position i + K - S, so the last query lines up with
    the last key."""
    B, S, H, D = q.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    logits, _ = _logits(q, k, causal, window, scale)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def split_p_block_k(D: int) -> int:
    """Keys per kv tile of the wgmma route: 128 at D <= 128, 64 at 256."""
    return 128 if D <= 128 else 64


def attention_split_p_ref(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The wgmma route's arithmetic (``csrc/flash_attention_fwd_wgmma.cu``)
    in plain torch, for the tests and ``chip_smoke.py``: online softmax
    over kv tiles of ``split_p_block_k(D)`` keys, f32 logits scaled to log2
    units, masked logits -1e30, and each tile's f32 P split into P_hi =
    bf16(P) and P_lo = bf16(P - P_hi), whose two products with V add into
    an f32 accumulator; l sums the f32 P.  Output acc / max(l, 1e-30) in
    q's type.  (The kernel skips the tiles the mask empties; here their P
    is wiped by the next live tile's exp(-1e30 - m) = 0, the same
    numbers.)"""
    B, S, H, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    BK = split_p_block_k(D)
    scale_log2 = float(torch.tensor(math.log2(math.e) / math.sqrt(D),
                                    dtype=torch.float32))
    qf = q.float().reshape(B, S, Hkv, G, D)
    m = torch.full((B, Hkv, G, S), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, S), device=q.device)
    acc = torch.zeros((B, Hkv, G, S, D), device=q.device)
    qpos = torch.arange(S, device=q.device)[:, None] + (K - S)
    for k0 in range(0, K, BK):
        kt, vt = k[:, k0:k0 + BK].float(), v[:, k0:k0 + BK].float()
        x = torch.einsum("bqhgd,bkhd->bhgqk", qf, kt) * scale_log2
        diff = qpos - torch.arange(k0, k0 + kt.shape[1], device=q.device)
        keep = torch.ones_like(diff, dtype=torch.bool)
        if causal:
            keep &= diff >= 0
        if window and window > 0:
            keep &= diff < window
        x = torch.where(keep, x, NEG_INF)
        mx = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - mx)
        p = torch.exp2(x - mx[..., None])
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        acc = (acc * corr[..., None]
               + torch.einsum("bhgqk,bkhd->bhgqd", hi, vt)
               + torch.einsum("bhgqk,bkhd->bhgqd", lo, vt))
        m = mx
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def attention_fwd_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0):
    """(out, lse): the forward and its rows' log-sum-exp, the counterpart
    of the JAX package's ``bwd.py::_fwd_with_lse``.  ``lse`` is f32 (B, H,
    S), head h = hkv * G + g."""
    B, S, H, D = q.shape
    logits, _ = _logits(q, k, causal, window, 1.0 / math.sqrt(D))
    lse = torch.logsumexp(logits, dim=-1)                  # (B, Hkv, G, S)
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype), lse.reshape(B, H, S)


def attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                      window: int = 0):
    """(dq, dk, dv) of the attention at (q, k, v) against the output
    gradient ``do``, from the forward's ``o`` and ``lse`` (B, H, S): the
    formula of the JAX package's ``bwd.py`` kernels.

    delta = rowsum(dO o) in f32 from the rounded ``o``; P = exp(s - lse);
    dS = P (dO Vᵀ - delta) scale; dq = dS K, dk = Σ_g dSᵀ Q, dv = Σ_g Pᵀ dO.
    dq takes q's type, dk and dv k's and v's."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    logits, qf = _logits(q, k, causal, window, scale)
    p = torch.exp(logits - lse.float().reshape(B, Hkv, G, S)[..., None])
    del logits
    dof = do.float().reshape(B, S, Hkv, G, D)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    delta = (do.float() * o.float()).sum(-1)                    # (B, S, H)
    delta = delta.reshape(B, S, Hkv, G).permute(0, 2, 3, 1)     # B,Hkv,G,S
    ds = p * (dp - delta[..., None]) * scale
    del dp
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def grad_limit(ref: torch.Tensor, n: int) -> torch.Tensor:
    """Per-element limit on |kernel - plain| for an output of ``ref``'s
    type that sums ``n`` f32 terms (dq: K keys; dk, dv: G * S query rows;
    lse: K keys), for inputs of unit scale (drawn standard normal).

    Both sides sum in f32, in other orders, and round once to the output
    type.  Each f32 addition rounds by at most 2^-24 of its partial sum,
    so two orders of a sum of n terms whose partial sums stay below 1
    differ by at most 2 n 2^-24: the floor (random-walk errors of longer
    sums with larger partials sit far below it).  Above it, a bf16 element
    may land one ulp of its own away, at most 2^-7 |ref|; f32 results carry
    the relative rounding of the D-term sums and the exp behind P and dS,
    some 128 * 2^-24 = 7.6e-6, bounded by 2^-14 = 6.1e-5.  Dropping one kv
    tile changes the rows that see it by its share of their probability, a
    percent or more, and fails this limit
    (``tests/test_torch_train.py``)."""
    return RTOL[ref.dtype] * ref.float().abs() + 2 * n * F32_ULP
