"""Device compute of the density pipeline: planning, the three tile-sweep
kernels and the engines that drive them."""
