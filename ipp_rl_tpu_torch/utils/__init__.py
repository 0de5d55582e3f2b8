"""Utilities of the port (copies of the JAX package's framework-free ones)."""
