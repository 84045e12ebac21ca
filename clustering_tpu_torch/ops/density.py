"""Per-frame neighbour populations and free energies.

Counterpart of ``clustering_tpu/ops/density.py``: ``populations`` is the
library entry point, on the tile-sweep path for the JAX package's
``backend="pallas"`` (and "auto") and on the dense plain version for its
``backend="xla"``; ``free_energies`` a copy (fp32 division and log, like
the reference); ``populations_dense`` the dense plain version of the
tile-sweep path (the counterpart of ``counts_rows``): a frame j counts
toward pop_i iff d2(i, j) <= r^2, j == i included.
"""

import numpy as np
import torch

from .engine import (DEFAULT_COL_BLOCK, DEFAULT_ROW_BLOCK, DensityEngine,
                     resolve_backend, resolve_device)
from .pairwise import sq_dists


def populations(coords, radii, row_block=DEFAULT_ROW_BLOCK,
                col_block=DEFAULT_COL_BLOCK, backend="auto", prune=True,
                device=None, mesh=None):
    """Neighbour populations for each radius: dict radius -> (N,) int64
    (self included), on ``device`` (default "cuda", or the mesh's).

    ``backend`` "auto" or "pallas": through :class:`DensityEngine`, over
    the devices of ``mesh`` if given, its tile list pruned unless ``prune``
    is False (``DensityEngine.populations``). "xla": the dense plain
    version (:func:`populations_dense`, no mesh), which is what the JAX
    package's XLA route computes. Anything else raises ValueError."""
    if resolve_backend(backend, dense=True, mesh=mesh):
        return populations_dense(coords, radii,
                                 device=resolve_device(device))
    engine = DensityEngine(coords, row_block, col_block, mesh=mesh,
                           device=device)
    return engine.populations(radii, prune=prune)


def free_energies(pops) -> np.ndarray:
    """fe_i = -ln(pop_i / max_pop), in fp32."""
    pops = np.asarray(pops)
    max_pop = np.float32(pops.max())
    ratio = pops.astype(np.float32) / max_pop
    return (-np.log(ratio.astype(np.float32))).astype(np.float32)


def populations_dense(coords, radii, device="cpu", row_block=1024):
    """Dense all-pairs counts: dict radius -> (N,) int64, self included."""
    x = torch.as_tensor(np.asarray(coords, dtype=np.float32), device=device)
    radii = list(radii)
    out = {}
    counts = torch.zeros((len(radii), x.shape[0]), dtype=torch.int64,
                         device=x.device)
    for lo in range(0, x.shape[0], row_block):
        d2 = sq_dists(x[lo:lo + row_block], x)
        for r_idx, r in enumerate(radii):
            r2 = float(np.float32(r) * np.float32(r))
            counts[r_idx, lo:lo + row_block] = (d2 <= r2).sum(dim=1)
    host = counts.cpu().numpy()
    for r_idx, r in enumerate(radii):
        out[r] = host[r_idx]
    return out
