"""Flash-attention forward: Hopper CUDA on the card, the plain PyTorch
version on CPU tensors."""
from .ops import flash_attention

__all__ = ["flash_attention"]
