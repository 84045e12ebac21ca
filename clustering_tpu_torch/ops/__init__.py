"""Device compute of the density pipeline: planning, the tile-sweep
kernels and the engines that drive them."""

from .density import free_energies, populations  # noqa: F401
from .neighbors import nearest_neighbors  # noqa: F401
from .screening import screening_labels  # noqa: F401
