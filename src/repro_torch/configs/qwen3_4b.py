"""qwen3-4b: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936,
qk_norm + GQA."""
from .lm_archs import QWEN3_4B as CONFIG, smoke
SMOKE = smoke(CONFIG)
