"""Cached-gather kernel for the DHT lookup: Hopper CUDA on the card, the
plain PyTorch version on CPU tensors."""
from .ops import dht_gather

__all__ = ["dht_gather"]
