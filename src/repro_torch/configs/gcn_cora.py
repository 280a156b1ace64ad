"""gcn-cora: 2 layers, d_hidden=16, mean/sym-norm aggregation."""
from ..models.gnn.gcn import GCNConfig
CONFIG = GCNConfig()
SMOKE = GCNConfig()
