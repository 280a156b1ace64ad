"""Architecture registry: an arch id resolves here.

Each entry: family ("lm" | "gnn" | "recsys"), full config, smoke config,
the shape set it pairs with, and the shapes it skips.  The JAX package's
registry, entry for entry: the five LM architectures, the four GNN models
and SASRec.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from . import lm_archs
from ..models.gnn.gcn import GCNConfig
from ..models.gnn.gin import GINConfig
from ..models.gnn.mace import MACEConfig
from ..models.gnn.schnet import SchNetConfig
from ..models.sasrec import SASRecConfig
from .shapes import GNN_SHAPES, LM_SHAPES, REC_SHAPES, ShapeSpec


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str
    config: Any
    smoke_config: Any
    shapes: Dict[str, ShapeSpec]
    skip_shapes: Dict[str, str] = dataclasses.field(default_factory=dict)


def _gnn_smoke(cfg):
    """A GNN config cut for CPU smoke tests: d_hidden at most 16, n_rbf
    at most 8."""
    kw = {}
    if hasattr(cfg, "d_hidden"):
        kw["d_hidden"] = min(cfg.d_hidden, 16)
    if hasattr(cfg, "n_rbf"):
        kw["n_rbf"] = min(cfg.n_rbf, 8)
    return dataclasses.replace(cfg, **kw)


REGISTRY: Dict[str, ArchEntry] = {}


def _reg(entry: ArchEntry):
    REGISTRY[entry.arch_id] = entry


_full_attn_skip = ("long_500k needs sub-quadratic attention; this arch is "
                   "pure full attention as configured (DESIGN.md §4)")

_reg(ArchEntry("gemma3-12b", "lm", lm_archs.GEMMA3_12B,
               lm_archs.smoke(lm_archs.GEMMA3_12B), LM_SHAPES))
_reg(ArchEntry("qwen2.5-32b", "lm", lm_archs.QWEN2_5_32B,
               lm_archs.smoke(lm_archs.QWEN2_5_32B), LM_SHAPES,
               {"long_500k": _full_attn_skip}))
_reg(ArchEntry("qwen3-4b", "lm", lm_archs.QWEN3_4B,
               lm_archs.smoke(lm_archs.QWEN3_4B), LM_SHAPES,
               {"long_500k": _full_attn_skip}))
_reg(ArchEntry("llama4-scout-17b-a16e", "lm", lm_archs.LLAMA4_SCOUT,
               lm_archs.smoke(lm_archs.LLAMA4_SCOUT), LM_SHAPES,
               {"long_500k": _full_attn_skip + "; llama4 chunked attention "
                "not reproduced"}))
_reg(ArchEntry("mixtral-8x22b", "lm", lm_archs.MIXTRAL_8X22B,
               lm_archs.smoke(lm_archs.MIXTRAL_8X22B), LM_SHAPES))

_reg(ArchEntry("mace", "gnn", MACEConfig(),
               _gnn_smoke(MACEConfig(d_hidden=16, n_rbf=4)), GNN_SHAPES))
_reg(ArchEntry("gin-tu", "gnn", GINConfig(),
               _gnn_smoke(GINConfig(d_hidden=16)), GNN_SHAPES))
_reg(ArchEntry("schnet", "gnn", SchNetConfig(),
               _gnn_smoke(SchNetConfig(d_hidden=16, n_rbf=8)), GNN_SHAPES))
_reg(ArchEntry("gcn-cora", "gnn", GCNConfig(), _gnn_smoke(GCNConfig()),
               GNN_SHAPES))
_reg(ArchEntry("sasrec", "recsys", SASRecConfig(),
               dataclasses.replace(SASRecConfig(), n_items=2048),
               REC_SHAPES))


def get(arch_id: str) -> ArchEntry:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def all_cells():
    """Yield (arch_id, shape_name, skipped_reason|None) for all 40 cells,
    in the reference's order."""
    for aid, entry in REGISTRY.items():
        for sname in entry.shapes:
            yield aid, sname, entry.skip_shapes.get(sname)
