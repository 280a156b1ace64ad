"""llama4-scout-17b-a16e: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert."""
from .lm_archs import LLAMA4_SCOUT as CONFIG, smoke
SMOKE = smoke(CONFIG)
