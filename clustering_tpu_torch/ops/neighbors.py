"""Joint nearest-neighbour / nearest-lower-free-energy-neighbour search.

Counterpart of ``clustering_tpu/ops/neighbors.py``:

  nh[i]   = argmin_j d2(i, j) over {j : d2(i, j) > 0}
  nhhd[i] = argmin_j d2(i, j) over {j : d2(i, j) > 0 and fe[j] < fe[i]}

Ties break toward the smallest j; zero-distance pairs (duplicate frames)
are excluded; a frame with no admissible neighbour reports (0, 0.0).
``nearest_neighbors`` is the library entry point, on the tile-sweep path
for the JAX package's ``backend="pallas"`` (and "auto") and on
``nearest_neighbors_dense``, the dense plain version of that path (the
counterpart of ``nn_rows``), for its ``backend="xla"``.
"""

import numpy as np
import torch

from .engine import (DEFAULT_COL_BLOCK, DEFAULT_ROW_BLOCK, DensityEngine,
                     resolve_backend, resolve_device)
from .pairwise import sq_dists

_INF = float("inf")


def nearest_neighbors(coords, free_energy, row_block=DEFAULT_ROW_BLOCK,
                      col_block=DEFAULT_COL_BLOCK, backend="auto",
                      prune=True, device=None, mesh=None):
    """Returns (nh_idx, nh_d2, nhhd_idx, nhhd_d2) numpy arrays of len N,
    on ``device`` (default "cuda", or the mesh's).

    ``backend`` "auto" or "pallas": through :class:`DensityEngine`, over
    the devices of ``mesh`` if given, with the two-phase pruning unless
    ``prune`` is False (``DensityEngine.nearest_neighbors``). "xla": the
    dense plain version (:func:`nearest_neighbors_dense`, no mesh).
    Anything else raises ValueError."""
    if resolve_backend(backend, dense=True, mesh=mesh):
        return nearest_neighbors_dense(coords, free_energy,
                                       device=resolve_device(device))
    engine = DensityEngine(coords, row_block, col_block, mesh=mesh,
                           device=device)
    return engine.nearest_neighbors(free_energy, prune=prune)


def nearest_neighbors_dense(coords, free_energy, device="cpu",
                            row_block=1024):
    """Returns (nh_idx, nh_d2, nhhd_idx, nhhd_d2) numpy arrays of len N."""
    x = torch.as_tensor(np.asarray(coords, dtype=np.float32), device=device)
    fe = torch.as_tensor(np.asarray(free_energy, dtype=np.float32),
                         device=x.device)
    ids, dists = [], []
    for lo in range(0, x.shape[0], row_block):
        d2 = sq_dists(x[lo:lo + row_block], x)
        d2_nh = torch.where(d2 > 0.0, d2, _INF)
        d2_hd = torch.where(fe[None, :] < fe[lo:lo + row_block, None],
                            d2_nh, _INF)
        both = torch.stack([d2_nh, d2_hd])
        # argmin returns the first (smallest-index) minimum
        ids.append(both.argmin(dim=2))
        dists.append(both.amin(dim=2))
    j = torch.cat(ids, dim=1)
    d = torch.cat(dists, dim=1)
    absent = ~(d < _INF)
    j = torch.where(absent, 0, j).cpu().numpy().astype(np.int64)
    d = torch.where(absent, 0.0, d).cpu().numpy().astype(np.float32)
    return j[0], d[0], j[1], d[1]


def compute_sigma2(nh_dist) -> float:
    """Mean squared NN distance (double accumulation, like the
    reference)."""
    return float(np.mean(np.asarray(nh_dist, dtype=np.float64)))
