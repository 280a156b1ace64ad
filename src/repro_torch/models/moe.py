"""Mixture-of-experts layer with sort-based (dropping) token dispatch: the
JAX package's ``models/moe.py`` in plain torch, on the device of ``x``.

Dispatch: tokens are routed top-k, their T·K assignment slots sorted by
expert (stably, as ``jnp.argsort`` sorts) and written into an (E·C + 1, d)
buffer, capacity C = ceil(T·K/E · capacity_factor) over all the tokens of
the call; a slot past its expert's capacity goes to the last row, the drop
slot, and adds nothing to its token's output (the residual passes
through).  The experts run as batched products over the E axis
(``torch.bmm``), so ``remat="dots"``, which saves only ``aten.mm`` and
``addmm``, recomputes them and keeps the router's product, as the
reference's ``dots_with_no_batch_dims_saveable`` does.

Routing: a softmax router in f32 over a product taken in ``x.dtype``, top-k
with ties to the lower expert index (``jax.lax.top_k``'s rule: a stable
descending sort, sliced), combine weights renormalized over the k chosen,
and a Switch-style load-balancing loss.  Every sort is stable, so a
recomputed layer routes exactly as its first pass did.

``moe_apply_block`` is the same global dispatch on one rank's blocks of
the weights, for the sharded decode (``TransformerLM.decode_step`` under
a ``ShardCtx``).

The reference has no Pallas kernel here (sort, gather, scatter and grouped
einsums in XLA); the port has none either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .layers import _normal, init_mlp, mlp_swiglu, mlp_swiglu_block


@dataclasses.dataclass(frozen=True)
class MoeSpec:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert: bool = False   # llama4: a shared expert beside the routed


def init_moe(generator: torch.Generator, spec: MoeSpec,
             dtype=torch.float32) -> Dict:
    """The reference's shapes and scales, drawn from ``generator`` (on its
    device): router (d, E), w_gate and w_up (E, d, f), w_down (E, f, d),
    and with a shared expert "shared" {w_gate, w_up, w_down}."""
    d, f, E = spec.d_model, spec.d_ff, spec.n_experts
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)
    p = {"router": _normal(generator, (d, E), dtype, s_in),
         "w_gate": _normal(generator, (E, d, f), dtype, s_in),
         "w_up": _normal(generator, (E, d, f), dtype, s_in),
         "w_down": _normal(generator, (E, f, d), dtype, s_out)}
    if spec.shared_expert:
        p["shared"] = init_mlp(generator, d, f, dtype)
    return p


class Routing(NamedTuple):
    """One call's routes and dispatch, the assignment slots in expert
    order (``order`` maps them back to token order)."""
    gate_idx: torch.Tensor    # (T, K) int64, each token's experts
    gate_vals: torch.Tensor   # (T, K) f32 combine weights
    aux: torch.Tensor         # () f32 load-balancing loss
    capacity: int
    order: torch.Tensor       # (A,) the token-order slot at each position
    token: torch.Tensor       # (A,) each sorted slot's token
    gate: torch.Tensor        # (A,) each sorted slot's weight, f32
    keep: torch.Tensor        # (A,) bool, within its expert's capacity
    buf_pos: torch.Tensor     # (A,) row of the buffer, E·C where dropped

    def kept_by_token(self) -> torch.Tensor:
        """The keep mask in token order, (T, K)."""
        keep = torch.empty_like(self.keep)
        keep[self.order] = self.keep
        return keep.reshape(self.gate_idx.shape)


def route(router: torch.Tensor, xt: torch.Tensor, spec: MoeSpec) -> Routing:
    """Routes and dispatch of the (T, d) tokens ``xt``, the capacity counted
    over all T of them."""
    return route_logits((xt @ router.to(xt.dtype)).float(), spec)


def route_logits(logits: torch.Tensor, spec: MoeSpec) -> Routing:
    """:func:`route` from the (T, E) f32 router logits."""
    T = logits.shape[0]
    E, K = spec.n_experts, spec.top_k
    device = logits.device
    probs = torch.softmax(logits, dim=-1)                          # (T, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :K], idx[:, :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # Switch aux loss: E * sum_e (mean router prob) * (share of slots)
    me = probs.mean(dim=0)
    slot_expert = gate_idx.reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=device).index_add_(
        0, slot_expert, torch.full(slot_expert.shape, 1.0 / (T * K),
                                   dtype=torch.float32, device=device))
    aux = E * torch.sum(me * ce)

    A = T * K
    C = int(math.ceil(A / E * spec.capacity_factor))
    slot_token = torch.arange(T, device=device).repeat_interleave(K)
    order = torch.argsort(slot_expert, stable=True)
    se, stok, sg = slot_expert[order], slot_token[order], \
        gate_vals.reshape(-1)[order]
    start = torch.searchsorted(se, torch.arange(E, device=device))
    rank = torch.arange(A, device=device) - start[se]
    keep = rank < C
    buf_pos = torch.where(keep, se * C + rank, E * C)
    return Routing(gate_idx, gate_vals, aux, C, order, stok, sg, keep,
                   buf_pos)


def _experts(params, buf: torch.Tensor, reduce_d=None, reduce_f=None
             ) -> torch.Tensor:
    """SwiGLU of each expert on its rows: buf (E, R, d) -> (E, R, d).  On
    one rank's (d, f) blocks of the weights (``moe_apply_block``) gate and
    up are partial over the d blocks, which ``reduce_d(t)`` all-reduces,
    and down over the f blocks (``reduce_f``)."""
    dt = buf.dtype
    g = torch.bmm(buf, params["w_gate"].to(dt))
    u = torch.bmm(buf, params["w_up"].to(dt))
    if reduce_d is not None:
        g, u = reduce_d(g), reduce_d(u)
    y = torch.bmm(F.silu(g) * u, params["w_down"].to(dt))
    return y if reduce_f is None else reduce_f(y)


def _dispatch(xt: torch.Tensor, r: Routing, E: int) -> torch.Tensor:
    """(E·C, d) expert inputs: each kept slot's token at its row; the drop
    slot's row is cut off."""
    C, d = r.capacity, xt.shape[1]
    buf = xt.new_zeros((E * C + 1, d)).index_put((r.buf_pos,), xt[r.token])
    return buf[:-1]


def _combine(y: torch.Tensor, r: Routing, T: int, dtype) -> torch.Tensor:
    """(T, d): each kept slot's expert output times its gate, summed into
    its token (at most two slots a token, so any order gives the same
    sum)."""
    EC = y.shape[0]
    contrib = torch.where(r.keep[:, None],
                          y[torch.clamp(r.buf_pos, max=EC - 1)]
                          * r.gate[:, None].to(dtype), 0)
    return y.new_zeros((T, y.shape[1])).index_add(0, r.token, contrib)


def moe_apply(params, x: torch.Tensor, spec: MoeSpec
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss f32), the capacity counted
    over all B·S tokens."""
    B, S, d = x.shape
    T, E = B * S, spec.n_experts
    xt = x.reshape(T, d)
    r = route(params["router"], xt, spec)
    y = _experts(params, _dispatch(xt, r, E).reshape(E, r.capacity, d))
    out = _combine(y.reshape(E * r.capacity, d), r, T, x.dtype)
    if spec.shared_expert:
        out = out + mlp_swiglu(params["shared"], xt)
    return out.reshape(B, S, d), r.aux


def moe_apply_local(params, x: torch.Tensor, spec: MoeSpec, dp_shards: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's locality-aware dispatch: the B·S tokens split into
    ``dp_shards`` shards of T/dp_shards, each routed and dispatched on its
    own with its own capacity; the experts run on every shard's buffer,
    and the aux loss is the shards' mean.  No path of the port reaches
    it: the reference calls it only under a sharding context."""
    B, S, d = x.shape
    T, E = B * S, spec.n_experts
    if T % dp_shards:
        raise ValueError(f"{T} tokens do not split into {dp_shards} shards")
    Tl = T // dp_shards
    xs = x.reshape(dp_shards, Tl, d)
    routes = [route(params["router"], xl, spec) for xl in xs]
    C = routes[0].capacity
    # (P, E, C, d) -> (E, P·C, d): one product an expert over every shard
    buf = torch.stack([_dispatch(xl, r, E) for xl, r in zip(xs, routes)])
    buf = buf.reshape(dp_shards, E, C, d).transpose(0, 1)
    y = _experts(params, buf.reshape(E, dp_shards * C, d))
    y = y.reshape(E, dp_shards, C, d).transpose(0, 1).reshape(
        dp_shards, E * C, d)
    out = torch.stack([_combine(yl, r, Tl, x.dtype)
                       for yl, r in zip(y, routes)]).reshape(B, S, d)
    if spec.shared_expert:
        out = out + mlp_swiglu(params["shared"], x)
    return out, torch.stack([r.aux for r in routes]).mean()


def moe_apply_block(params, x: torch.Tensor, spec: MoeSpec, d_block: slice,
                    reduce_d, reduce_f) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global dispatch of :func:`moe_apply` with the weights as one
    rank's blocks: the router's rows and every expert's (d block, f block)
    (``w_gate``, ``w_up`` (E, d_l, f_l), ``w_down`` (E, f_l, d_l); the
    shared expert's alike).  x (B, S, d) is whole and the same on every
    rank.  The router's product is partial over the d blocks
    (``reduce_d(t)`` all-reduces it), so every rank routes the same tokens
    with the same capacity and drops the same ones; each rank dispatches
    its d block of them; gate and up are reduced by ``reduce_d``, SwiGLU
    runs on the f block and down is reduced by ``reduce_f`` (over the f
    blocks).  No weight leaves its rank.  Returns (this rank's d block of
    the output (B, S, d_l), aux)."""
    B, S, d = x.shape
    T, E = B * S, spec.n_experts
    xt = x.reshape(T, d)
    xb = xt[:, d_block]
    r = route_logits(reduce_d(xb @ params["router"].to(xt.dtype)).float(),
                     spec)
    y = _experts(params, _dispatch(xb, r, E).reshape(E, r.capacity, -1),
                 reduce_d, reduce_f)
    out = _combine(y.reshape(E * r.capacity, -1), r, T, x.dtype)
    if spec.shared_expert:
        out = out + mlp_swiglu_block(params["shared"], xt, d_block,
                                     reduce_d, reduce_f)
    return out.reshape(B, S, -1), r.aux
