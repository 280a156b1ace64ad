"""AdamW with a warmup-cosine schedule and f32 global-norm clipping: the
JAX package's ``optim/adamw.py`` in plain torch.

The reference is functional: it returns new parameters and state.  Here
the update runs in place under ``no_grad``, one leaf at a time, because a
functional copy of qwen3-4b's 16 GiB of f32 parameters would not fit
beside them on one card.  The arithmetic is the reference's, in its order,
in f32: clip, the moments, bias correction, then ``p - lr (m̂ / (sqrt(v̂)
+ eps) + wd p)`` with weight decay on every leaf, cast back to each
parameter's own type (as the reference does; it keeps no separate f32
master copy).  ``torch.optim.AdamW`` orders these operations otherwise
(decoupled decay applied before the step) and is not this function.

State: ``{"m": {name: tensor}, "v": {name: tensor}, "step": int32
tensor}``, the moments in ``state_dtype`` ("float32" or "bfloat16"), keyed
by the parameter names of ``nn.Module.named_parameters``.

Sharded parameters (DTensors, ``launch.sharding``) get moments with their
placements, and the update runs on each rank's shards: the global norm's
sum of squares is made a replicated value before the square root, so
every rank clips alike, and the schedule's scalars join the DTensor
arithmetic as replicated values.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Mapping, Tuple, Union

import torch
from torch import nn

from ..devices import is_dtensor, whole

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"   # "bfloat16" halves m and v


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine decay to ``min_lr_frac * lr``
    at ``total_steps``; f32, on ``step``'s device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_state(params: Union[nn.Module, Mapping[str, torch.Tensor]],
               cfg: AdamWConfig = None) -> Dict:
    """Zero moments like each parameter (in ``cfg.state_dtype``, f32
    without a config) and step 0, on the parameters' devices."""
    dtype = STATE_DTYPES[cfg.state_dtype if cfg is not None else "float32"]
    named = _named(params)
    zeros = {n: torch.zeros_like(p, dtype=dtype,
                                 memory_format=torch.contiguous_format)
             for n, p in named.items()}
    device = next(iter(named.values())).device
    return {"m": zeros,
            "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square, in f32, leaf by leaf.
    Over DTensors the sum is replicated (every rank's partial sums
    reduced) before the square root, and the norm is a plain tensor."""
    total = None
    for t in tensors:
        sq = (t.float() ** 2).sum()
        total = sq if total is None else total + sq
    return torch.sqrt(whole(total))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig,
                  params: Union[nn.Module, Mapping[str, torch.Tensor]],
                  grads: Mapping[str, torch.Tensor], state: Dict
                  ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: every parameter named in ``grads`` moves,
    ``state``'s moments and step advance.  Returns ``(state, {"lr",
    "grad_norm"})``, the metrics as f32 tensors."""
    named = _named(params)
    if set(grads) != set(named):
        raise ValueError("grads must name every parameter exactly")
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads[n] for n in named)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    dev = step.device
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(cfg.b1, dev), stepf)
    bc2 = 1 - torch.pow(_f32(cfg.b2, dev), stepf)
    with _replicated_scalars(any(is_dtensor(p) for p in named.values())):
        _update(cfg, named, grads, state, scale, lr, bc1, bc2)
    state["step"] = step
    return state, {"lr": lr, "grad_norm": gnorm}


def _replicated_scalars(sharded: bool):
    """Where parameters are DTensors, plain 0-d tensors (the schedule's
    scalars) act as replicated DTensors in the update."""
    if not sharded:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _update(cfg, named, grads, state, scale, lr, bc1, bc2):
    for name, p in named.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        del g
        m.copy_(m32)
        v.copy_(v32)
        mh = m32.div_(bc1)
        delta = mh.div_(v32.div_(bc2).sqrt_().add_(cfg.eps))
        del v32
        delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
        del delta, mh
