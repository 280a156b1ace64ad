"""mixtral-8x22b: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, SWA 4096."""
from .lm_archs import MIXTRAL_8X22B as CONFIG, smoke
SMOKE = smoke(CONFIG)
