"""Architecture registry: an arch id resolves here.

Each entry: family, full config, smoke config, the shape set it pairs
with, and the shapes it skips.  The port registers the five LM
architectures; the GNN and RecSys entries of the JAX package's registry
come with their slices, and ``get`` names the ROADMAP item for each.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from . import lm_archs
from .shapes import LM_SHAPES, ShapeSpec


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str
    config: Any
    smoke_config: Any
    shapes: Dict[str, ShapeSpec]
    skip_shapes: Dict[str, str] = dataclasses.field(default_factory=dict)


REGISTRY: Dict[str, ArchEntry] = {}

# in the JAX package's registry, not ported yet
NOT_PORTED = {
    "mace": "GNN models (ROADMAP queue 1, item 11)",
    "gin-tu": "GNN models (ROADMAP queue 1, item 11)",
    "schnet": "GNN models (ROADMAP queue 1, item 11)",
    "gcn-cora": "GNN models (ROADMAP queue 1, item 11)",
    "sasrec": "RecSys models (ROADMAP queue 1, item 11)",
}


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


def get(arch_id: str) -> ArchEntry:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch '{arch_id}' is not ported yet: {NOT_PORTED[arch_id]}")
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
