"""Host utilities of the port: its own copies of the JAX package's file
formats, logger and native codec loaders, and the stage timer."""
