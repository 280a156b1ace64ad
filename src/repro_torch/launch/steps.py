"""Step functions, the counterparts of the JAX package's
``launch/steps.py``, each in place on a model's parameters and AdamW
state:
  * lm_train_step    — forward, backward and AdamW (microbatches)
  * lm_prefill_step  — the KV cache and the last position's logits
  * lm_decode_step   — one token against a (possibly ring) KV cache
  * gnn_train_step / gnn_forward_step — the four GNN archs
    (``GNN_MODULES``)
  * rec_train_step / rec_serve_step / rec_retrieval_step — SASRec

A parameter that the loss never reads (MACE's ``mix_v`` and ``mix_t``)
has no autograd gradient; the steps give it a zero one, as ``jax.grad``
does, so AdamW's weight decay still moves it.

The LM steps take a ``ShardCtx`` (``sctx``): the caller places the
parameters and AdamW's moments once by ``sharding.lm_param_shardings`` on
its mesh (:func:`place_lm`), as the reference's ``in_shardings`` do, and
each data rank computes on its contiguous block of the global batch, as
GSPMD splits it.
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
from .sharding import lm_param_shardings, place_params, place_tensors

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


def place_lm(model: TransformerLM, opt_state: Optional[Dict],
             sctx: ShardCtx) -> None:
    """Place ``model``'s parameters and ``opt_state``'s moments (in
    place) by ``lm_param_shardings`` on ``sctx.mesh``: ZeRO-sharded state,
    Megatron-split projections.  The step counter stays a plain tensor,
    the same on every rank.  Called once, before the steps."""
    shardings = lm_param_shardings(sctx.mesh, dict(model.named_parameters()))
    place_params(model, shardings)
    if opt_state is not None:
        for key in ("m", "v"):
            opt_state[key] = place_tensors(opt_state[key], shardings)


def _check_placed(model: TransformerLM, sctx: ShardCtx) -> None:
    """Raise unless ``model``'s parameters are on ``sctx.mesh`` (its first
    one checked): a step under a context runs on a placed state."""
    p = model.embed
    if not is_dtensor(p) or p.device_mesh != sctx.mesh:
        raise ValueError("the parameters are not placed on the context's "
                         "mesh: call place_lm(model, opt_state, sctx) once "
                         "before the steps")


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
        _check_placed(model, sctx)
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
        _check_placed(model, sctx)
    return model.prefill(tokens, sctx=sctx)


def lm_decode_step(model: TransformerLM, cache, token,
                   sctx: Optional[ShardCtx] = None):
    """(logits (B, V), the cache with ``length + 1``) of one (B,) token;
    the new keys and values are written into ``cache`` in place (under
    ``sctx``, the parameters placed by :func:`place_lm`: gathered,
    decoded and placed back)."""
    if sctx is not None:
        _check_placed(model, sctx)
    return model.decode_step(cache, token, sctx=sctx)


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


def gnn_train_step(model: nn.Module, opt_cfg: adamw.AdamWConfig,
                   opt_state: Dict, batch: GraphBatch
                   ) -> Dict[str, torch.Tensor]:
    """One step of any of the four GNN models (``GNN_MODELS``): loss,
    backward and AdamW, in place on ``model``'s parameters and
    ``opt_state``.  Returns the metrics ``loss``, the model's own
    (``nll`` or ``mse``), ``lr`` and ``grad_norm`` as tensors."""
    named = dict(model.named_parameters())
    for p in named.values():
        p.grad = None
    loss, metrics = model.loss_fn(batch)
    loss.backward()
    grads = _grads(named)
    _, opt_metrics = adamw.apply_updates(opt_cfg, named, grads, opt_state)
    for p in named.values():
        p.grad = None
    return {"loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}


@torch.no_grad()
def gnn_forward_step(model: nn.Module, batch: GraphBatch) -> torch.Tensor:
    """The model's output on one batch, without gradients: GIN's logits
    (n_graphs, n_classes), GCN's (N, n_classes), SchNet's and MACE's
    energies (n_graphs,)."""
    return model(batch)


def rec_train_step(model: SASRec, opt_cfg: adamw.AdamWConfig,
                   opt_state: Dict, item_seq, pos_items,
                   neg_items) -> Dict[str, torch.Tensor]:
    """One step: the BPR loss, backward and AdamW, in place on ``model``'s
    parameters and ``opt_state``.  The item table's gradient is dense, as
    ``jax.grad`` gives it.  Returns the metrics ``loss``, ``bpr``, ``lr``
    and ``grad_norm`` as tensors."""
    named = dict(model.named_parameters())
    for p in named.values():
        p.grad = None
    loss, metrics = model.loss_fn(item_seq, pos_items, neg_items)
    loss.backward()
    grads = _grads(named)
    _, opt_metrics = adamw.apply_updates(opt_cfg, named, grads, opt_state)
    for p in named.values():
        p.grad = None
    return {"loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}


@torch.no_grad()
def rec_serve_step(model: SASRec, item_seq, candidates) -> torch.Tensor:
    """Scores (B, C) of each user's candidates, from the state at the last
    position of their (B, S) history."""
    states = model.encode(item_seq)
    return model.score_candidates(states[:, -1], candidates)


@torch.no_grad()
def rec_retrieval_step(model: SASRec, item_seq) -> torch.Tensor:
    """Scores (B, n_items) of each user against the whole item table."""
    states = model.encode(item_seq)
    return model.retrieval_scores(states[:, -1])
