"""Step functions: the counterparts of the JAX package's
``launch/steps.py::lm_train_step``, ``gnn_train_step`` and
``gnn_forward_step`` (GIN; the other GNN models' steps come with them,
ROADMAP queue 1, item 2), and ``rec_train_step``, ``rec_serve_step`` and
``rec_retrieval_step`` (SASRec).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models.gnn.common import GraphBatch
from ..models.gnn.gin import GIN
from ..models.sasrec import SASRec
from ..models.transformer import TransformerLM
from ..optim import adamw


def lm_train_step(model: TransformerLM, opt_cfg: adamw.AdamWConfig,
                  opt_state: Dict, tokens, labels) -> Dict[str, torch.Tensor]:
    """One step: forward, backward and AdamW, in place on ``model``'s
    parameters and ``opt_state``.  Returns the metrics ``loss``, ``nll``,
    ``aux``, ``lr`` and ``grad_norm`` as tensors.

    With ``cfg.n_microbatches`` n > 1 the batch is split into n equal
    microbatches along B, one backward each; their gradients accumulate
    in the parameters' f32 ``.grad`` and are divided by n, and the loss is
    the microbatches' mean (the reference's scan).  Activation memory is
    that of one microbatch.
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
    # every parameter takes part in the loss, so every one has a grad
    grads = {n: p.grad for n, p in named.items()}
    _, opt_metrics = adamw.apply_updates(opt_cfg, named, grads, opt_state)
    for p in named.values():
        p.grad = None
    return {"loss": loss, **metrics, **opt_metrics}


def gnn_train_step(model: GIN, opt_cfg: adamw.AdamWConfig, opt_state: Dict,
                   batch: GraphBatch) -> Dict[str, torch.Tensor]:
    """One step: loss, backward and AdamW, in place on ``model``'s
    parameters and ``opt_state``.  Returns the metrics ``loss``, ``nll``,
    ``lr`` and ``grad_norm`` as tensors."""
    named = dict(model.named_parameters())
    for p in named.values():
        p.grad = None
    loss, metrics = model.loss_fn(batch)
    loss.backward()
    grads = {n: p.grad for n, p in named.items()}
    _, opt_metrics = adamw.apply_updates(opt_cfg, named, grads, opt_state)
    for p in named.values():
        p.grad = None
    return {"loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}


@torch.no_grad()
def gnn_forward_step(model: GIN, batch: GraphBatch) -> torch.Tensor:
    """The logits (n_graphs, n_classes) of one batch, without gradients."""
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
    grads = {n: p.grad for n, p in named.items()}
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
