"""Assigned input-shape sets per architecture family.

LM shapes: seq_len x global_batch; decode_*/long_* lower ``serve_step``
(1 new token against a KV cache), not ``train_step``.  The GNN and RecSys
sets of the JAX package's ``configs/shapes.py`` come with their models
(ROADMAP queue 1, item 11); ``ShapeSpec`` keeps their fields.
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
