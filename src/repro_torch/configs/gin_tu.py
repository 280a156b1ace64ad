"""gin-tu: 5 layers, d_hidden=64, sum aggregator, learnable eps."""
from ..models.gnn.gin import GINConfig
CONFIG = GINConfig()
SMOKE = GINConfig(d_hidden=16)
