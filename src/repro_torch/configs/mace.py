"""mace: 2 layers, 128 channels, l_max=2, correlation 3, 8 RBF, E(3)-ACE."""
from ..models.gnn.mace import MACEConfig
CONFIG = MACEConfig()
SMOKE = MACEConfig(d_hidden=16, n_rbf=4)
