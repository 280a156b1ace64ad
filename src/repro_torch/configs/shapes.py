"""Assigned input-shape sets per architecture family.

LM shapes: seq_len x global_batch; decode_*/long_* lower ``serve_step``
(1 new token against a KV cache), not ``train_step``.  GNN shapes:
graph-scale regimes.  RecSys shapes: users per call of SASRec's training,
serving and full-table retrieval steps.  A copy of the JAX package's
``configs/shapes.py``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    # train | prefill | decode | gnn_full | gnn_sampled | gnn_batched
    # | rec_train | rec_serve | rec_retrieval
    kind: str
    seq_len: int = 0
    global_batch: int = 0
    # gnn
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple = ()
    n_graphs: int = 0
    # recsys
    n_candidates: int = 0


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768,
                             global_batch=32),
    "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768,
                            global_batch=128),
    "long_500k": ShapeSpec("long_500k", "decode", seq_len=524288,
                           global_batch=1),
}

GNN_SHAPES = {
    # Cora-scale full batch
    "full_graph_sm": ShapeSpec("full_graph_sm", "gnn_full", n_nodes=2708,
                               n_edges=10556, d_feat=1433),
    # Reddit-scale sampled minibatch (fanout 15,10 from 1024 seeds)
    "minibatch_lg": ShapeSpec("minibatch_lg", "gnn_sampled", n_nodes=232965,
                              n_edges=114615892, d_feat=602,
                              batch_nodes=1024, fanout=(15, 10)),
    # ogbn-products full batch
    "ogb_products": ShapeSpec("ogb_products", "gnn_full", n_nodes=2449029,
                              n_edges=61859140, d_feat=100),
    # batched small molecules
    "molecule": ShapeSpec("molecule", "gnn_batched", n_nodes=30, n_edges=64,
                          n_graphs=128),
}

REC_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "rec_train", global_batch=65536),
    "serve_p99": ShapeSpec("serve_p99", "rec_serve", global_batch=512),
    "serve_bulk": ShapeSpec("serve_bulk", "rec_serve", global_batch=262144),
    "retrieval_cand": ShapeSpec("retrieval_cand", "rec_retrieval",
                                global_batch=1, n_candidates=1_000_000),
}


def sampled_block_sizes(spec: ShapeSpec):
    """Layer-wise sampled-subgraph sizes for minibatch_lg: node/edge counts
    of the padded 2-hop block (seeds=1024, fanout 15 then 10)."""
    seeds = spec.batch_nodes
    l1 = seeds * spec.fanout[0]
    l2 = l1 * spec.fanout[1]
    n_nodes = seeds + l1 + l2
    n_edges = l1 + l2
    return n_nodes, n_edges
