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
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..models.gnn import gcn, gin, mace, schnet
from ..models.gnn.common import GraphBatch
from ..models.sasrec import SASRec
from ..models.transformer import TransformerConfig, TransformerLM
from ..optim import adamw

GNN_MODULES = {"gcn-cora": gcn, "gin-tu": gin, "schnet": schnet, "mace": mace}
# each arch's model: ``GNN_MODELS[arch](cfg, params=None, *, device=None,
# seed=0)``, on CUDA unless ``device`` asks for the CPU
GNN_MODELS = {"gcn-cora": gcn.GCN, "gin-tu": gin.GIN,
              "schnet": schnet.SchNet, "mace": mace.MACE}


def _grads(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each parameter's ``.grad``, a zero one where autograd left none (a
    parameter the loss does not read): ``jax.grad``'s gradient."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in named.items()}


def lm_train_step(model: TransformerLM, opt_cfg: adamw.AdamWConfig,
                  opt_state: Dict, tokens, labels) -> Dict[str, torch.Tensor]:
    """One step: forward, backward and AdamW, in place on ``model``'s
    parameters and ``opt_state``.  Returns the metrics ``loss``, ``nll``,
    ``aux``, ``lr`` and ``grad_norm`` as tensors.

    With ``cfg.n_microbatches`` n > 1 the batch is split into n equal
    microbatches along B, one backward each; their gradients accumulate
    in the parameters' f32 ``.grad`` and are divided by n, and the loss is
    the microbatches' mean (the reference's scan).  Activation memory is
    that of one microbatch, and an MoE layer's capacity is counted over
    one microbatch's tokens, as in the reference.
    """
    cfg = model.cfg
    tokens = torch.as_tensor(tokens, device=model.device).long()
    labels = torch.as_tensor(labels, device=model.device).long()
    n_micro = max(cfg.n_microbatches, 1)
    B = tokens.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         f"microbatches")
    named = dict(model.named_parameters())
    for p in named.values():
        p.grad = None
    if n_micro == 1:
        loss, metrics = model.loss_fn(tokens, labels)
        loss.backward()
        loss, metrics = loss.detach(), {k: v.detach()
                                        for k, v in metrics.items()}
    else:
        mb = B // n_micro
        loss_sum = aux_sum = 0.0
        for i in range(n_micro):
            part = slice(i * mb, (i + 1) * mb)
            loss_i, m = model.loss_fn(tokens[part], labels[part])
            loss_i.backward()
            loss_sum = loss_sum + loss_i.detach()
            aux_sum = aux_sum + m["aux"].detach()
        for p in named.values():
            p.grad.div_(n_micro)
        loss = loss_sum / n_micro
        metrics = {"nll": loss, "aux": aux_sum / n_micro}
    grads = _grads(named)
    _, opt_metrics = adamw.apply_updates(opt_cfg, named, grads, opt_state)
    for p in named.values():
        p.grad = None
    return {"loss": loss, **metrics, **opt_metrics}


def lm_prefill_step(model: TransformerLM, tokens):
    """(last logits (B, V), cache {"k", "v": (L, B, S, Hkv, hd), "length":
    (B,) int32}) of a (B, S) prompt."""
    return model.prefill(tokens)


def lm_decode_step(model: TransformerLM, cache, token):
    """(logits (B, V), the cache with ``length + 1``) of one (B,) token;
    the new keys and values are written into ``cache`` in place."""
    return model.decode_step(cache, token)


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
