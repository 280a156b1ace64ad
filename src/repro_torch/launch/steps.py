"""Step functions, the counterparts of the JAX package's
``launch/steps.py``, each in place on a model's parameters and AdamW
state:
  * lm_train_step    — forward, backward and AdamW (microbatches)
  * lm_prefill_step  — the KV cache and the last position's logits
  * lm_decode_step   — one token against a (possibly ring) KV cache
    (``place_cache`` places a prefill's cache for it once)
  * gnn_train_step / gnn_forward_step — the four GNN archs
    (``GNN_MODULES``)
  * rec_train_step / rec_serve_step / rec_retrieval_step — SASRec

A parameter that the loss never reads (MACE's ``mix_v`` and ``mix_t``)
has no autograd gradient; the steps give it a zero one, as ``jax.grad``
does, so AdamW's weight decay still moves it.

Every step takes a ``ShardCtx`` (``sctx``), and the caller places the
state once on its mesh, as the reference's ``in_shardings`` do: the LM's
parameters and AdamW's moments by ``sharding.lm_param_shardings``
(:func:`place_lm`), each data rank computing on its contiguous block of
the global batch, as GSPMD splits it; a GNN's replicated
(:func:`place_gnn`), its batch's node and edge arrays split over every
mesh axis (:func:`place_graph_batch`, which the GNN steps run on a batch
of plain tensors); SASRec's by ``sharding.rec_param_shardings``, the item
table's rows over the model axis (:func:`place_rec`), the batch over the
data axes.  Under a context a replicated parameter's gradient, a partial
sum over the ranks that split its activations, is all-reduced before
AdamW's global norm, so every rank clips alike.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..devices import is_dtensor, whole

from ..models.gnn import gcn, gin, mace, schnet
from ..models.gnn.common import GraphBatch
from ..models.sasrec import SASRec
from ..models.transformer import ShardCtx, TransformerConfig, TransformerLM
from ..optim import adamw
from ..placement import maybe_implicit
from .sharding import (graph_batch_shardings, kv_cache_shardings,
                       lm_param_shardings, place_params, place_tensors,
                       rec_param_shardings, replicated)

GNN_MODULES = {"gcn-cora": gcn, "gin-tu": gin, "schnet": schnet, "mace": mace}
# each arch's model: ``GNN_MODELS[arch](cfg, params=None, *, device=None,
# seed=0)``, on CUDA unless ``device`` asks for the CPU
GNN_MODELS = {"gcn-cora": gcn.GCN, "gin-tu": gin.GIN,
              "schnet": schnet.SchNet, "mace": mace.MACE}


def _grads(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each parameter's ``.grad``, a zero one where autograd left none (a
    parameter the loss does not read): ``jax.grad``'s gradient.  A
    DTensor parameter's gradient is put in the parameter's placements
    (autograd may leave it a partial sum over ranks)."""
    grads = {}
    for n, p in named.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if is_dtensor(g) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        grads[n] = g
    return grads


def _place(model: nn.Module, opt_state: Optional[Dict], rule,
           sctx: ShardCtx) -> None:
    shardings = rule(sctx.mesh, dict(model.named_parameters()))
    place_params(model, shardings)
    if opt_state is not None:
        for key in ("m", "v"):
            opt_state[key] = place_tensors(opt_state[key], shardings)


def place_lm(model: TransformerLM, opt_state: Optional[Dict],
             sctx: ShardCtx) -> None:
    """Place ``model``'s parameters and ``opt_state``'s moments (in
    place) by ``lm_param_shardings`` on ``sctx.mesh``: ZeRO-sharded state,
    Megatron-split projections.  The step counter stays a plain tensor,
    the same on every rank.  Called once, before the steps."""
    _place(model, opt_state, lm_param_shardings, sctx)


def place_gnn(model: nn.Module, opt_state: Optional[Dict],
              sctx: ShardCtx) -> None:
    """Place a GNN's parameters and ``opt_state``'s moments (in place)
    replicated on ``sctx.mesh``, as the reference's GNN cells do.  Called
    once, before the steps."""
    _place(model, opt_state, replicated, sctx)


def place_rec(model: SASRec, opt_state: Optional[Dict],
              sctx: ShardCtx) -> None:
    """Place SASRec's parameters and ``opt_state``'s moments (in place) by
    ``rec_param_shardings``: the item table's rows over the model axis,
    the rest replicated.  Called once, before the steps."""
    _place(model, opt_state, rec_param_shardings, sctx)


def _check_placed(model: nn.Module, sctx: ShardCtx, place: str) -> None:
    """Raise unless ``model``'s parameters are on ``sctx.mesh`` (its first
    one checked): a step under a context runs on a placed state."""
    p = next(model.parameters())
    if not is_dtensor(p) or p.device_mesh != sctx.mesh:
        raise ValueError(f"the parameters are not placed on the context's "
                         f"mesh: call {place}(model, opt_state, sctx) once "
                         f"before the steps")


def place_graph_batch(batch: GraphBatch, sctx: ShardCtx) -> GraphBatch:
    """``batch`` (global tensors, the same on every rank) placed by
    ``sharding.graph_batch_shardings``, the reference's ``flat_shard``:
    each rank keeps its block of every node and edge array, with no
    communication.  A field that is a DTensor already (a rank's own
    shard, say) stays."""
    import dataclasses

    def place(t, sh):
        return t if is_dtensor(t) else sh.distribute(t)

    out = {}
    for f, sh in graph_batch_shardings(sctx.mesh, batch).items():
        t = getattr(batch, f)
        out[f] = (tuple(map(place, t, sh)) if f == "overflow"
                  else place(t, sh))
    return dataclasses.replace(batch, **out)


def lm_train_step(model: TransformerLM, opt_cfg: adamw.AdamWConfig,
                  opt_state: Dict, tokens, labels,
                  sctx: Optional[ShardCtx] = None
                  ) -> Dict[str, torch.Tensor]:
    """One step: forward, backward and AdamW, in place on ``model``'s
    parameters and ``opt_state``.  Returns the metrics ``loss``, ``nll``,
    ``aux``, ``lr`` and ``grad_norm`` as tensors.

    Under ``sctx`` (every rank given the same global batch, the state
    placed by :func:`place_lm`) data rank r computes on the r-th
    contiguous block of rows, as GSPMD splits the reference's batch; the
    gradients are the global batch's, the metrics plain tensors, the same
    on every rank.  Each microbatch must split into the data shards.

    With ``cfg.n_microbatches`` n > 1 the batch is split into n equal
    contiguous microbatches along B (the reference's scan), each split
    over the data shards in turn, one backward each; their gradients accumulate
    in the parameters' f32 ``.grad`` and are divided by n, and the loss is
    the microbatches' mean (the reference's scan).  Activation memory is
    that of one microbatch, and an MoE layer's capacity is counted over
    one microbatch's tokens, as in the reference.
    """
    cfg = model.cfg
    n_micro = max(cfg.n_microbatches, 1)
    n_data = 1
    if sctx is not None:
        _check_placed(model, sctx, "place_lm")
        n_data = sctx.dp_size
    tokens = torch.as_tensor(tokens, device=model.device).long()
    labels = torch.as_tensor(labels, device=model.device).long()
    B = tokens.shape[0]
    if B % (n_micro * n_data):
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         f"microbatches of {n_data} data shards")
    named = dict(model.named_parameters())
    for p in named.values():
        p.grad = None
    if n_micro == 1:
        loss, metrics = model.loss_fn(tokens, labels, sctx=sctx)
        loss.backward()
        loss, metrics = whole(loss.detach()), {
            k: whole(v.detach()) for k, v in metrics.items()}
    else:
        mb = B // n_micro
        loss_sum = aux_sum = 0.0
        for i in range(n_micro):
            part = slice(i * mb, (i + 1) * mb)
            loss_i, m = model.loss_fn(tokens[part], labels[part], sctx=sctx)
            loss_i.backward()
            loss_sum = loss_sum + whole(loss_i.detach())
            aux_sum = aux_sum + whole(m["aux"].detach())
        for p in named.values():
            p.grad.div_(n_micro)
        loss = loss_sum / n_micro
        metrics = {"nll": loss, "aux": aux_sum / n_micro}
    grads = _grads(named)
    _, opt_metrics = adamw.apply_updates(opt_cfg, named, grads, opt_state)
    for p in named.values():
        p.grad = None
    return {"loss": loss, **metrics, **opt_metrics}


def lm_prefill_step(model: TransformerLM, tokens,
                    sctx: Optional[ShardCtx] = None):
    """(last logits (B, V), cache {"k", "v": (L, B, S, Hkv, hd), "length":
    (B,) int32}) of a (B, S) prompt.  Under ``sctx`` (the parameters
    placed by :func:`place_lm`) data rank r prefills the r-th contiguous
    block of rows; the logits and k, v are DTensors."""
    if sctx is not None:
        _check_placed(model, sctx, "place_lm")
    return model.prefill(tokens, sctx=sctx)


def lm_decode_step(model: TransformerLM, cache, token,
                   sctx: Optional[ShardCtx] = None):
    """(logits (B, V), the cache with ``length + 1``) of one (B,) token;
    the new keys and values are written into ``cache`` in place.  Under
    ``sctx`` the parameters are placed by :func:`place_lm` and the cache's
    k and v by :func:`place_cache`; the step is weight-stationary (no
    parameter or cache shard leaves its rank), the logits a DTensor of
    rows over the data axes and the vocabulary over the model axis, the
    cache in its placements.  A cache in other placements than
    ``sharding.kv_cache_shardings``' raises ``ValueError``."""
    if sctx is not None:
        _check_placed(model, sctx, "place_lm")
        _check_cache_placed(cache, sctx)
    return model.decode_step(cache, token, sctx=sctx)


def _check_cache_placed(cache, sctx: ShardCtx) -> None:
    """Raise unless the cache's k and v are DTensors on ``sctx.mesh`` in
    ``sharding.kv_cache_shardings``' placements."""
    shape = tuple(cache["k"].shape)
    want = kv_cache_shardings(sctx.mesh, shape, shape[1]).placements
    for name in ("k", "v"):
        t = cache[name]
        got = tuple(t.placements) if is_dtensor(t) else "a plain tensor"
        if got != want or t.device_mesh != sctx.mesh:
            raise ValueError(
                f"the cache's {name!r} must arrive placed {want} on the "
                f"context's mesh (sharding.kv_cache_shardings; place_cache "
                f"places a prefill's cache once), not {got}")


def place_cache(cache, sctx: ShardCtx):
    """A KV cache ({"k", "v": (L, B, S, Hkv, hd), "length": (B,)}) with k
    and v placed by ``sharding.kv_cache_shardings``, as the reference's
    decode takes them: rows over the data axes where B splits over them,
    else the slots over the data axis (one long stream), head_dim over the
    model axis.  A prefill's cache (rows over the data axes, kv heads over
    the model axis) is redistributed, plain tensors (the same on every
    rank) distributed; ``length`` stays as it is.  Call it once, between
    the prefill and the decode steps: the steps keep the placements."""
    shape = tuple(cache["k"].shape)
    sh = kv_cache_shardings(sctx.mesh, shape, shape[1])
    placed = place_tensors({"k": cache["k"], "v": cache["v"]},
                           {"k": sh, "v": sh})
    return {**cache, **placed}


def lm_cache_shape(cfg: TransformerConfig, batch: int, seq_len: int):
    """Allocated KV-cache shape (L, B, S, Hkv, hd) a ring-buffer
    ``decode_step`` needs for ``seq_len`` tokens: S bounded by the window
    when every layer is windowed (mixtral: at most 4096 slots, the older
    positions overwritten in the ring), the full length otherwise, when
    any layer is global (gemma3) or none is windowed (qwen2.5, qwen3,
    llama4)."""
    if cfg.sliding_window > 0 and cfg.local_global_ratio == 0:
        S = min(seq_len, cfg.sliding_window)
    else:
        S = seq_len
    return (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)


def _train(model: nn.Module, opt_cfg: adamw.AdamWConfig, opt_state: Dict,
           loss_fn, sctx: Optional[ShardCtx]) -> Dict[str, torch.Tensor]:
    """``loss_fn()``'s backward and AdamW, in place; the metrics as
    tensors (plain tensors, the same on every rank, under ``sctx``)."""
    named = dict(model.named_parameters())
    for p in named.values():
        p.grad = None
    with maybe_implicit(sctx):
        loss, metrics = loss_fn()
        loss.backward()
    grads = _grads(named)
    _, opt_metrics = adamw.apply_updates(opt_cfg, named, grads, opt_state)
    for p in named.values():
        p.grad = None
    return {"loss": whole(loss.detach()),
            **{k: whole(v.detach()) for k, v in metrics.items()},
            **opt_metrics}


def gnn_train_step(model: nn.Module, opt_cfg: adamw.AdamWConfig,
                   opt_state: Dict, batch: GraphBatch,
                   sctx: Optional[ShardCtx] = None
                   ) -> Dict[str, torch.Tensor]:
    """One step of any of the four GNN models (``GNN_MODELS``): loss,
    backward and AdamW, in place on ``model``'s parameters and
    ``opt_state``.  Returns the metrics ``loss``, the model's own
    (``nll`` or ``mse``), ``lr`` and ``grad_norm`` as tensors.

    Under ``sctx`` (the state placed by :func:`place_gnn`) the batch is
    placed by :func:`place_graph_batch` (every rank given the same global
    batch, or its own shards as DTensors) and each rank computes on its
    node and edge rows; the gradients are the whole graph's."""
    if sctx is not None:
        _check_placed(model, sctx, "place_gnn")
        batch = place_graph_batch(batch, sctx)
    return _train(model, opt_cfg, opt_state,
                  lambda: model.loss_fn(batch, sctx=sctx), sctx)


@torch.no_grad()
def gnn_forward_step(model: nn.Module, batch: GraphBatch,
                     sctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """The model's output on one batch, without gradients: GIN's logits
    (n_graphs, n_classes), GCN's (N, n_classes), SchNet's and MACE's
    energies (n_graphs,).  Under ``sctx`` as :func:`gnn_train_step`: a
    DTensor (GCN's logits node rows, the rest replicated)."""
    if sctx is None:
        return model(batch)
    _check_placed(model, sctx, "place_gnn")
    with sctx.implicit():
        return model(place_graph_batch(batch, sctx), sctx=sctx)


def rec_train_step(model: SASRec, opt_cfg: adamw.AdamWConfig,
                   opt_state: Dict, item_seq, pos_items, neg_items,
                   sctx: Optional[ShardCtx] = None
                   ) -> Dict[str, torch.Tensor]:
    """One step: the BPR loss, backward and AdamW, in place on ``model``'s
    parameters and ``opt_state``.  The item table's gradient is dense, as
    ``jax.grad`` gives it.  Returns the metrics ``loss``, ``bpr``, ``lr``
    and ``grad_norm`` as tensors.  Under ``sctx`` (the state placed by
    :func:`place_rec`; every rank given the same global batch) data rank r
    computes on the r-th contiguous block of rows, and the table's
    gradient stays split over the model axis, summed over the data
    axes."""
    if sctx is not None:
        _check_placed(model, sctx, "place_rec")
    return _train(model, opt_cfg, opt_state, lambda: model.loss_fn(
        item_seq, pos_items, neg_items, sctx=sctx), sctx)


@torch.no_grad()
def rec_serve_step(model: SASRec, item_seq, candidates,
                   sctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Scores (B, C) of each user's candidates, from the state at the last
    position of their (B, S) history (under ``sctx`` a DTensor of rows
    over the data axes, or replicated where B does not divide)."""
    if sctx is not None:
        _check_placed(model, sctx, "place_rec")
    with maybe_implicit(sctx):
        states = model.encode(item_seq, sctx)
        return model.score_candidates(states[:, -1], candidates, sctx)


@torch.no_grad()
def rec_retrieval_step(model: SASRec, item_seq,
                       sctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Scores (B, n_items) of each user against the whole item table
    (under ``sctx`` a DTensor split over the model axis on the item
    dimension: the table is never gathered)."""
    if sctx is not None:
        _check_placed(model, sctx, "place_rec")
    with maybe_implicit(sctx):
        states = model.encode(item_seq, sctx)
        return model.retrieval_scores(states[:, -1], sctx)
