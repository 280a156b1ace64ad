"""Model configurations of the port: the five LM architectures
(``lm_archs``), the shape sets (``shapes``) and the registry."""
