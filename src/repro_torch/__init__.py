"""PyTorch / CUDA port of the AMPC reproduction (``repro``), for one NVIDIA
Hopper card.

Laid out like the JAX package: ``repro_torch.ampc`` (the engine — start at
``repro_torch.ampc.AmpcEngine``), ``repro_torch.core`` (algorithm
primitives, the DHT, the round ledger), ``repro_torch.graph`` (containers
and generators), ``repro_torch.kernels`` (hand-written Hopper kernels) and
``repro_torch.obs`` (tracing and metrics).  It imports neither ``jax`` nor
``repro``; ``repro_torch.convert`` carries graphs across.
"""
