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

``moe_apply_block`` is the one dispatch body: ``moe_apply`` runs it with
the whole d, one shard and no reductions, ``moe_apply_local`` (the
per-shard dispatch) with one shard a data shard; under a ``ShardCtx`` it
runs on one rank's blocks of the weights and of d, its partial sums
reduced and its gradients carried back by the context's collectives (the
sharded train and prefill steps' regions in ``TransformerLM._sharded_moe``,
the sharded decode's ``TransformerLM._ffn_block``).

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


def _experts(params, buf: torch.Tensor, sctx=None, d_axes=()
             ) -> torch.Tensor:
    """SwiGLU of each expert on its rows: buf (E, R, d) -> (E, R, d).  On
    one rank's (d, f) blocks of the weights (``moe_apply_block`` under a
    context) gate and up are partial over the d blocks, all-reduced over
    ``d_axes``, the SiLU product's gradient likewise, and down is partial
    over the f blocks (the caller reduces it)."""
    dt = buf.dtype
    g = torch.bmm(buf, params["w_gate"].to(dt))
    u = torch.bmm(buf, params["w_up"].to(dt))
    if sctx is not None:
        g, u = sctx.reduce(g, d_axes), sctx.reduce(u, d_axes)
    h = F.silu(g) * u
    if sctx is not None:
        h = sctx.reduce_grad(h, d_axes)
    return torch.bmm(h, params["w_down"].to(dt))


def _dispatch(xt: torch.Tensor, r: Routing, E: int) -> torch.Tensor:
    """(E·C, d) expert inputs: each kept slot's token at its row; the drop
    slot's row is cut off."""
    C, d = r.capacity, xt.shape[1]
    buf = xt.new_zeros((E * C + 1, d)).index_put((r.buf_pos,), xt[r.token])
    return buf[:-1]


def _combine(y: torch.Tensor, r: Routing, T: int, dtype, gate=None
             ) -> torch.Tensor:
    """(T, d): each kept slot's expert output times its gate (``r.gate``
    where ``gate`` is None), summed into its token (at most two slots a
    token, so any order gives the same sum)."""
    EC = y.shape[0]
    gate = r.gate if gate is None else gate
    contrib = torch.where(r.keep[:, None],
                          y[torch.clamp(r.buf_pos, max=EC - 1)]
                          * gate[:, None].to(dtype), 0)
    return y.new_zeros((T, y.shape[1])).index_add(0, r.token, contrib)


def moe_apply(params, x: torch.Tensor, spec: MoeSpec
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss f32), the capacity counted
    over all B·S tokens: :func:`moe_apply_block` with the whole d and no
    reductions, plus the shared expert."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    out, aux = moe_apply_block(params, xt, spec)
    if spec.shared_expert:
        out = out + mlp_swiglu(params["shared"], xt)
    return out.reshape(B, S, d), aux


def moe_apply_local(params, x: torch.Tensor, spec: MoeSpec, shards: int,
                    sctx=None, f_axes=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's locality-aware dispatch: the tokens of ``x`` (...,
    d) split into ``shards`` contiguous shards, each routed and dispatched
    on its own with its own capacity (:func:`moe_apply_block` at
    ``shards``), the aux loss the shards' mean; plus the shared expert.
    Returns (out, the shape of x; aux f32).

    Under ``sctx`` (``TransformerLM._sharded_moe``) ``x`` is one data
    rank's tokens, each weight's d whole and its f the rank's block over
    ``f_axes``: ``out`` is partial over ``f_axes`` (the caller reduces
    it) and the tokens' gradient is all-reduced over them."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    out, aux = moe_apply_block(params, xt, spec, sctx, (), f_axes, shards)
    if spec.shared_expert:
        xs = xt if sctx is None else sctx.reduce_grad(xt, f_axes)
        out = out + mlp_swiglu_block(params["shared"], xs, sctx, (), f_axes,
                                     reduce_f=False)
    return out.reshape(x.shape), aux


def moe_apply_block(params, xb: torch.Tensor, spec: MoeSpec, sctx=None,
                    d_axes=(), f_axes=(), shards: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts of T tokens, ``xb`` (T, d_l) their block of d:
    routes, capacity and drops counted over each of ``shards`` contiguous
    shards of T/shards tokens (over all T at one shard, the global
    dispatch), then dispatch, experts (one batched product an expert over
    every shard's buffer) and combine.  Returns (out (T, d_l), aux f32, the
    shards' mean).

    Without ``sctx`` d is whole and nothing is reduced (:func:`moe_apply`,
    :func:`moe_apply_local`).  Under ``sctx`` the weights are one rank's
    blocks: the router's rows of d, every expert's (d block, f block)
    (``w_gate``, ``w_up`` (E, d_l, f_l), ``w_down`` (E, f_l, d_l)),
    ``d_axes`` the axes that split d and ``f_axes`` those that split f.
    The router's product is partial over the d blocks and all-reduced in
    f32, so every rank routes the same tokens with the same capacity and
    drops the same ones; each rank dispatches its d block; gate and up are
    all-reduced over ``d_axes``, SwiGLU runs on the f block, and down is
    partial over the f blocks: ``out`` is returned partial over ``f_axes``
    (the caller reduces it, with a shared expert's).  Backward, the
    dispatched tokens' gradient is all-reduced over ``f_axes``, the SiLU
    product's over ``d_axes`` and the combine weights' over both; no
    weight leaves its rank."""
    T, E = xb.shape[0], spec.n_experts
    if T % shards:
        raise ValueError(f"{T} tokens do not split into {shards} shards")

    def split(t):   # the shards' tokens (one shard: t itself)
        return [t] if shards == 1 else t.reshape(shards, -1,
                                                 t.shape[-1]).unbind(0)

    xs = split(xb)
    if sctx is None:
        routes = [route(params["router"], xl, spec) for xl in xs]
        gates, xe = [None] * shards, xs
    else:
        routes = [route_logits(sctx.reduce(
            (xl @ params["router"].to(xb.dtype)).float(), d_axes), spec)
            for xl in xs]
        gates = [sctx.reduce_grad(r.gate, tuple(d_axes) + tuple(f_axes))
                 for r in routes]
        xe = split(sctx.reduce_grad(xb, f_axes))
    C = routes[0].capacity
    # (E, shards·C, d_l): one product an expert over every shard's rows
    bufs = [_dispatch(xl, r, E).reshape(E, C, -1)
            for xl, r in zip(xe, routes)]
    buf = bufs[0] if shards == 1 else torch.stack(bufs, 1).reshape(
        E, shards * C, -1)
    y = _experts(params, buf, sctx, d_axes).reshape(E, shards, C, -1)
    outs = [_combine(yl.reshape(E * C, -1), r, T // shards, xb.dtype, g)
            for yl, r, g in zip(y.unbind(1), routes, gates)]
    if shards == 1:
        return outs[0], routes[0].aux
    return torch.cat(outs), torch.stack([r.aux for r in routes]).mean()
