"""Synthetic data pipelines of the port (numpy, identical to the JAX
package's, so both draw the same batches from a seed)."""
