"""schnet: 3 interactions, d_hidden=64, 300 RBF, cutoff 10."""
from ..models.gnn.schnet import SchNetConfig
CONFIG = SchNetConfig()
SMOKE = SchNetConfig(d_hidden=16, n_rbf=8)
