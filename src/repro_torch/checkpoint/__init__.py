"""The numpy checkpointer, the port of the JAX package's ``checkpoint/``."""
