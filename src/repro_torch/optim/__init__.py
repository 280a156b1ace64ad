"""AdamW, the port of the JAX package's ``optim/adamw.py``."""
