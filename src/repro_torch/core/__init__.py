"""Algorithm primitives, the DHT and the round ledger (torch port)."""
