"""sasrec: embed_dim=50, 2 blocks, 1 head, seq_len=50, 1M-item table."""
import dataclasses
from ..models.sasrec import SASRecConfig
CONFIG = SASRecConfig()
SMOKE = dataclasses.replace(SASRecConfig(), n_items=2048)
