"""The plain reference of the decoder-only LMs the benchmark runs: the
published architecture written out in plain PyTorch, in float32.

It imports nothing of the program.  It takes the parameters, tokens and
KV cache that the benchmark made (``perfbench.weights``,
``perfbench.traffic``), the same tensors the program was given, and works
out everything else again: the forward pass, the loss, the gradients
(autograd through these functions), AdamW (``reference.adamw``) and the
decode through a ring-buffer cache.

The architecture, as the configuration files state it: token embedding;
per layer RMSNorm (scale ``1 + s``), attention with grouped KV heads,
optional per-head RMSNorm of q and k, RoPE on split halves at each
token's position, a causal (optionally windowed) softmax in f32, the
output projection and a residual; RMSNorm, then a SwiGLU FFN or a
mixture of experts (softmax router, top-k with ties to the lower index,
the k gates renormalized, a load-balancing loss E·Σ mean prob · share of
slots, dropping dispatch at capacity ceil(T·K/E · capacity_factor) in
token order), and a residual; a final RMSNorm and the head (the embedding
transposed where tied).  The training loss is the mean next-token NLL of
each microbatch plus the aux weight times the layers' summed
load-balancing losses, averaged over the microbatches.

``prec="fp8"`` is the control: the same functions with every product's
two operands rounded to float8 e4m3 under a per-tensor scale (amax to
448) and the product then taken in f32, a precision below the bf16 that
the configurations compute in.  Its gradients pass the rounding
straight through.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

NEG = -1e30
E4M3_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Dims:
    """The model's sizes and switches, read from a configuration file."""
    vocab: int
    n_layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    theta: float
    eps: float
    qk_norm: bool
    qkv_bias: bool
    tied: bool
    window: int
    experts: int
    top_k: int
    capacity_factor: float
    aux_weight: float

    @classmethod
    def of(cls, config: dict) -> "Dims":
        d, heads = config["hidden_size"], config["num_attention_heads"]
        return cls(vocab=config["vocab_size"],
                   n_layers=config["num_hidden_layers"], d=d, heads=heads,
                   kv_heads=config["num_key_value_heads"],
                   head_dim=config.get("head_dim") or d // heads,
                   d_ff=config["intermediate_size"],
                   theta=float(config["rope_theta"]),
                   eps=float(config["rms_norm_eps"]),
                   qk_norm=bool(config.get("qk_norm")),
                   qkv_bias=bool(config.get("attention_bias")),
                   tied=bool(config.get("tie_word_embeddings")),
                   window=int(config.get("sliding_window") or 0),
                   experts=int(config.get("num_local_experts") or 0),
                   top_k=int(config.get("num_experts_per_tok") or 0),
                   capacity_factor=float(config.get("capacity_factor", 1.0)),
                   aux_weight=float(config.get("router_aux_loss_coef", 0.0)))


@contextlib.contextmanager
def exact_f32():
    """f32 products in f32: TF32 off for matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude to 448), back in f32; the gradient passes straight through."""
    if x.numel() == 0:
        return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach() if x.requires_grad else q


def _op(x, prec):
    return fp8(x) if prec == "fp8" else x


def mm(a, b, prec="f32"):
    return _op(a, prec) @ _op(b, prec)


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, pos, theta):
    """x (..., S, H, hd) rotated at ``pos`` (..., S) on split halves; the
    angles in float64."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = pos.to(torch.float64)[..., None] * inv
    cos = torch.cos(ang).float()[..., None, :]
    sin = torch.sin(ang).float()[..., None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def qkv(p, prefix, h, pos, dims: Dims, prec):
    """Rotated q (b, s, H, hd), k and v (b, s, Hkv, hd) of normed ``h``."""
    b, s, _ = h.shape
    q = mm(h, p[prefix + "attn.wq"], prec)
    k = mm(h, p[prefix + "attn.wk"], prec)
    v = mm(h, p[prefix + "attn.wv"], prec)
    if dims.qkv_bias:
        q = q + p[prefix + "attn.bq"]
        k = k + p[prefix + "attn.bk"]
        v = v + p[prefix + "attn.bv"]
    q = q.reshape(b, s, dims.heads, dims.head_dim)
    k = k.reshape(b, s, dims.kv_heads, dims.head_dim)
    v = v.reshape(b, s, dims.kv_heads, dims.head_dim)
    if dims.qk_norm:
        q = rms_norm(q, p[prefix + "attn.q_norm"], dims.eps)
        k = rms_norm(k, p[prefix + "attn.k_norm"], dims.eps)
    return rope(q, pos, dims.theta), rope(k, pos, dims.theta), v


def attend(q, k, v, keep, prec):
    """softmax(q kᵀ / sqrt(hd), masked by ``keep``) v, one kv head's group
    of query heads at a time.  q (b, s, H, hd); k, v (b, K, Hkv, hd);
    keep broadcastable to (b, s, K)."""
    b, s, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    outs = []
    for j in range(Hkv):
        qj = q[:, :, j * G:(j + 1) * G]                      # (b, s, G, hd)
        logits = torch.einsum("bsgd,bkd->bgsk", _op(qj, prec),
                              _op(k[:, :, j], prec)) / math.sqrt(hd)
        logits = torch.where(keep[:, None], logits, NEG)
        pr = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bgsk,bkd->bsgd", _op(pr, prec),
                                 _op(v[:, :, j], prec)))
    return torch.cat(outs, dim=2)


def swiglu(x, w_gate, w_up, w_down, prec):
    g = mm(x, w_gate, prec)
    u = mm(x, w_up, prec)
    return mm(torch.nn.functional.silu(g) * u, w_down, prec)


def moe(p, prefix, x, dims: Dims, prec):
    """The routed experts of the (T, d) tokens ``x``: (out (T, d), aux)."""
    T = x.shape[0]
    E, K = dims.experts, dims.top_k
    probs = torch.softmax(mm(x, p[prefix + "moe.router"], prec), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :K], idx[:, :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    slots = idx.reshape(-1)                       # token-major slot order
    share = torch.bincount(slots, minlength=E).float() / (T * K)
    aux = E * torch.sum(probs.mean(0) * share)
    cap = math.ceil(T * K / E * dims.capacity_factor)
    flat_gates = gates.reshape(-1)
    out = torch.zeros_like(x)
    for e in range(E):
        mine = torch.nonzero(slots == e)[:, 0][:cap]   # kept, in slot order
        tok = mine // K
        y = swiglu(x[tok], p[prefix + "moe.w_gate"][e],
                   p[prefix + "moe.w_up"][e], p[prefix + "moe.w_down"][e],
                   prec)
        out = out.index_add(0, tok, y * flat_gates[mine, None])
    return out, aux


def ffn(p, prefix, h, dims: Dims, prec):
    """The layer's FFN on normed ``h`` (b, s, d): (out, aux or None)."""
    if dims.experts:
        b, s, d = h.shape
        out, aux = moe(p, prefix, h.reshape(b * s, d), dims, prec)
        return out.reshape(b, s, d), aux
    return swiglu(h, p[prefix + "mlp.w_gate"], p[prefix + "mlp.w_up"],
                  p[prefix + "mlp.w_down"], prec), None


def causal_keep(s: int, window: int, device):
    pos = torch.arange(s, device=device)
    diff = pos[:, None] - pos[None, :]
    keep = diff >= 0
    if window > 0:
        keep &= diff < window
    return keep[None]


def layer(p, i, x, dims: Dims, prec):
    """One decoder layer on x (b, s, d): (x, aux)."""
    prefix = f"layers.{i}."
    s = x.shape[1]
    pos = torch.arange(s, device=x.device)
    q, k, v = qkv(p, prefix, rms_norm(x, p[prefix + "ln1"], dims.eps), pos,
                  dims, prec)
    a = attend(q, k, v, causal_keep(s, dims.window, x.device), prec)
    x = x + mm(a.reshape(*x.shape[:2], -1), p[prefix + "attn.wo"], prec)
    out, aux = ffn(p, prefix, rms_norm(x, p[prefix + "ln2"], dims.eps),
                   dims, prec)
    if aux is None:
        aux = x.new_zeros(())
    return x + out, aux


def head_weight(p, dims: Dims):
    return p["embed"].T if dims.tied else p["lm_head"]


# rows of the head's logits taken at once by the loss
LOSS_ROWS = 1024


def _nll_sum(xn, head, labels, prec):
    logits = mm(xn, head, prec)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).sum()


def loss(p: Dict[str, torch.Tensor], tokens, labels, dims: Dims,
         prec: str = "f32"):
    """The microbatch's loss: mean next-token NLL plus ``aux_weight`` times
    the layers' summed load-balancing losses.  Each layer, and each block
    of the head's logits, is recomputed in the backward rather than kept."""
    x = p["embed"][tokens]
    aux = x.new_zeros(())
    for i in range(dims.n_layers):
        x, a = checkpoint(layer, p, i, x, dims, prec, use_reentrant=False)
        aux = aux + a
    xn = rms_norm(x, p["final_norm"], dims.eps).reshape(-1, dims.d)
    lab = labels.reshape(-1)
    head = head_weight(p, dims)
    total = xn.new_zeros(())
    for r in range(0, xn.shape[0], LOSS_ROWS):
        total = total + checkpoint(_nll_sum, xn[r:r + LOSS_ROWS], head,
                                   lab[r:r + LOSS_ROWS], prec,
                                   use_reentrant=False)
    return total / lab.numel() + dims.aux_weight * aux


def loss_and_grads(p: Dict[str, torch.Tensor], tokens, labels, dims: Dims,
                   microbatches: int, prec: str = "f32"):
    """(mean loss over the microbatches, gradients) of one step's batch
    (B, S), split into ``microbatches`` contiguous microbatches; the
    gradients are the microbatches' mean, left in each leaf's ``.grad``."""
    B = tokens.shape[0]
    mb = B // microbatches
    total = 0.0
    for t in p.values():
        t.grad = None
    with exact_f32():
        for i in range(microbatches):
            part = slice(i * mb, (i + 1) * mb)
            li = loss(p, tokens[part], labels[part], dims, prec)
            li.backward()
            total += float(li.detach())
    for t in p.values():
        t.grad.div_(microbatches)
    return total / microbatches


# ----------------------------------------------------------------- decode
class RingDecoder:
    """Decode steps through a ring-buffer KV cache, in f32.

    ``cache_k``, ``cache_v`` (L, B, S, Hkv, hd) are the cache as the
    benchmark made it, read only; slot j of it holds the key of position j
    (every slot filled, ``length0`` = S positions so far, or any length0:
    slot j holds the latest position congruent to j below length0).  Step
    t writes its key and value, rounded to the cache's type, to slot
    (length0 + t) mod S, kept in this decoder's own buffer, and attends
    every slot whose position lies within [0, length0 + t] (and, for a
    windowed model, less than the window back)."""

    def __init__(self, p, cache_k, cache_v, length0: int, dims: Dims,
                 max_steps: int, prec: str = "f32"):
        self.p, self.k0, self.v0, self.dims = p, cache_k, cache_v, dims
        self.prec = prec
        L, B, S, Hkv, hd = cache_k.shape
        self.S, self.B, self.length0 = S, B, length0
        if max_steps > S:
            raise ValueError("the ring would wrap past its own writes")
        shape = (L, B, max_steps, Hkv, hd)
        self.new_k = torch.empty(shape, dtype=cache_k.dtype,
                                 device=cache_k.device)
        self.new_v = torch.empty_like(self.new_k)
        self.t = 0

    def _positions(self):
        """(slot index of each step written so far, the position each
        slot holds (S,))."""
        S, cur = self.S, self.length0 + self.t
        slots = (self.length0 + torch.arange(self.t + 1)) % S
        j = torch.arange(S)
        # the latest position congruent to j that is at most cur
        pos = cur - ((cur - j) % S)
        return slots, pos

    def _layer_cache(self, cache, new, slots):
        """Layer's keys or values as this decoder sees them, f32 (B, Hkv, S,
        hd): the benchmark's cache with the slots this decoder wrote."""
        B, S, Hkv, hd = cache.shape
        out = torch.empty((B, Hkv, S, hd), dtype=torch.float32,
                          device=cache.device)
        out.copy_(cache.permute(0, 2, 1, 3))
        out[:, :, slots] = new[:, :self.t + 1].permute(0, 2, 1, 3).float()
        return out

    @torch.no_grad()
    def step(self, token: torch.Tensor) -> torch.Tensor:
        """Logits (B, V) f32 of one token (B,) a row; advances the ring.
        ``p`` holds f32 leaves."""
        p, dims, prec = self.p, self.dims, self.prec
        dev = self.k0.device
        cur = self.length0 + self.t
        slots, pos = self._positions()
        slots, pos = slots.to(dev), pos.to(dev)
        keep = pos >= 0
        if dims.window > 0:
            keep &= (cur - pos) < dims.window
        x = p["embed"][token][:, None, :]                       # (B, 1, d)
        at = torch.full((self.B, 1), cur, device=dev)
        with exact_f32():
            for i in range(dims.n_layers):
                prefix = f"layers.{i}."
                q, k, v = qkv(p, prefix, rms_norm(x, p[prefix + "ln1"],
                                                  dims.eps), at, dims, prec)
                self.new_k[i, :, self.t] = k[:, 0].to(self.new_k.dtype)
                self.new_v[i, :, self.t] = v[:, 0].to(self.new_v.dtype)
                a = attend_cache(
                    q, self._layer_cache(self.k0[i], self.new_k[i], slots),
                    self._layer_cache(self.v0[i], self.new_v[i], slots),
                    keep, prec)
                x = x + mm(a.reshape(self.B, 1, -1), p[prefix + "attn.wo"],
                           prec)
                out, _ = ffn(p, prefix, rms_norm(x, p[prefix + "ln2"],
                                                 dims.eps), dims, prec)
                x = x + out
            xn = rms_norm(x[:, 0], p["final_norm"], dims.eps)
            logits = mm(xn, head_weight(p, dims), prec)
        self.t += 1
        return logits


def attend_cache(q, kk, vv, keep, prec):
    """One token a row against the cache: q (B, 1, H, hd); kk, vv (B, Hkv,
    S, hd) f32; keep (S,).  Returns (B, 1, H, hd)."""
    B, _, H, hd = q.shape
    Hkv = kk.shape[1]
    qh = q.reshape(B, Hkv, H // Hkv, hd)
    logits = _op(qh, prec) @ _op(kk, prec).transpose(-1, -2) / math.sqrt(hd)
    logits = torch.where(keep, logits, NEG)
    pr = torch.softmax(logits, dim=-1)
    return (_op(pr, prec) @ _op(vv, prec)).reshape(B, 1, H, hd)


def decode_reference(p, cache_k, cache_v, length0: int, tokens, dims: Dims,
                     prec: str = "f32", others: Optional[List] = None):
    """Teacher-forced decode over ``tokens`` (n + 1, B), ``p`` the f32
    leaves: step t feeds row
    b's ``tokens[t, b]`` and is judged on ``tokens[t + 1, b]``.  Returns
    (gap (n, B): how far the reference's logit of the served token lies
    below its best, the decoder with the keys and values it wrote).

    ``others`` are further decoders (the control) fed the same tokens
    beside this one: each step's logits of each are handed back as
    ``(gap of its top token under this reference's logits)`` in a list
    (n, B) per decoder."""
    n = tokens.shape[0] - 1
    ref = RingDecoder(p, cache_k, cache_v, length0, dims, n, prec)
    gaps = torch.empty((n, tokens.shape[1]), dtype=torch.float32,
                       device=cache_k.device)
    other_gaps = [torch.empty_like(gaps) for _ in (others or [])]
    for t in range(n):
        logits = ref.step(tokens[t])
        best = logits.max(-1).values
        gaps[t] = best - logits.gather(-1, tokens[t + 1, :, None])[:, 0]
        for dec, g in zip(others or [], other_gaps):
            top = dec.step(tokens[t]).argmax(-1)
            g[t] = best - logits.gather(-1, top[:, None])[:, 0]
    return gaps, ref, other_gaps
