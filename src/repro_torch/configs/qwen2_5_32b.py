"""qwen2.5-32b: 64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064,
GQA + QKV bias."""
from .lm_archs import QWEN2_5_32B as CONFIG, smoke
SMOKE = smoke(CONFIG)
