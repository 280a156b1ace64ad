"""gemma3-12b: 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144,
5:1 local:global sliding window, 128k context."""
from .lm_archs import GEMMA3_12B as CONFIG, smoke
SMOKE = smoke(CONFIG)
