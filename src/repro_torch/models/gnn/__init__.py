"""GNN models of the port: GCN (``gcn``), GIN (``gin``), SchNet
(``schnet``) and MACE (``mace``) over the shared substrate
(``common``)."""
