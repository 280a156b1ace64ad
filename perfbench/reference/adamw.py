"""AdamW as the benchmark's training cells configure it, in float32, in
place on a dict of leaves: clip the gradients by their global norm, the
moments, bias correction, then ``p - lr (m̂ / (sqrt(v̂) + eps) + wd p)``
with weight decay on every leaf, under a linear warmup and a cosine decay
to ``min_lr_frac`` of the rate."""
from __future__ import annotations

import math
from typing import Dict

import torch


def rate(opt: dict, step: int) -> float:
    """The learning rate at ``step`` (counted from 1)."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    cos = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * cos


def init(params: Dict[str, torch.Tensor]) -> dict:
    return {"m": {n: torch.zeros_like(p) for n, p in params.items()},
            "v": {n: torch.zeros_like(p) for n, p in params.items()},
            "step": 0}


@torch.no_grad()
def clip_scale(opt: dict, params: Dict[str, torch.Tensor]):
    """(the factor that clips the leaves' ``.grad`` to the global norm,
    each leaf's norm before it)."""
    norms = {n: torch.linalg.vector_norm(p.grad) for n, p in params.items()}
    total = torch.sqrt(sum(v * v for v in norms.values()))
    return torch.clamp(opt["clip_norm"] / torch.clamp(total, min=1e-9),
                       max=1.0), norms


@torch.no_grad()
def step(opt: dict, params: Dict[str, torch.Tensor], state: dict
         ) -> Dict[str, float]:
    """One step from each leaf's ``.grad``.  Returns the clip scale and
    each leaf's clipped gradient norm, as the update sees them."""
    state["step"] += 1
    t = state["step"]
    lr = rate(opt, t)
    scale, norms = clip_scale(opt, params)
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    for n, p in params.items():
        g = p.grad * scale
        m, v = state["m"][n], state["v"][n]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m / bc1) / ((v / bc2).sqrt_().add_(opt["eps"]))
        upd.add_(p, alpha=opt["weight_decay"])
        p.sub_(upd, alpha=lr)
        p.grad = None
    return {"scale": float(scale),
            "grad_norms": {n: float(v * scale) for n, v in norms.items()}}
