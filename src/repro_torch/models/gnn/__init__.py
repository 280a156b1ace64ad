"""GNN models of the port: GIN (``gin``) over the shared substrate
(``common``)."""
