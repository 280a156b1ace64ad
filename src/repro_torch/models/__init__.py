"""Models of the port: the decoder-only LM (``transformer``) and its
building blocks (``layers``), and the GNNs (``gnn``)."""
