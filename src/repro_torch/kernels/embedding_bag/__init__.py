"""Sum-mode EmbeddingBag: Hopper CUDA on the card, the plain PyTorch
version on CPU tensors."""
from .ops import embedding_bag

__all__ = ["embedding_bag"]
