"""Flash attention, forward and backward: Hopper CUDA on the card, the
plain PyTorch versions on CPU tensors."""
from .ops import flash_attention

__all__ = ["flash_attention"]
