"""Graph containers and generators (numpy, host side)."""
