"""Host utilities of the port (the file formats are the JAX package's)."""
