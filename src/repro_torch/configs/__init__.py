"""Model configurations of the port: the five LM architectures
(``lm_archs``), the shape sets (``shapes``), the registry, and one module
an arch (``CONFIG`` and ``SMOKE``, as in the JAX package)."""
