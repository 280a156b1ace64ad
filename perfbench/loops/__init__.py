"""The general loops a traffic mix names by its ``loop`` key: each has
``run(cell, seed, seconds, trace, device, clock0)`` returning the run's
record (``loops.common.Record``)."""
