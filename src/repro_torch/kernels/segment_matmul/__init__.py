"""Padded-neighbour gather-sum and matmul (GIN's aggregation): Hopper CUDA
on the card, the plain PyTorch version on CPU tensors."""
from .ops import segment_matmul

__all__ = ["segment_matmul"]
