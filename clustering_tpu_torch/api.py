"""High-level Python API of the PyTorch port (counterpart of
``clustering_tpu.api`` for the density stages):

    import clustering_tpu_torch as ctt

    pops = ctt.populations(coords, radius, device="cuda")
    fe = ctt.free_energies(pops)
    nn = ctt.nearest_neighbors(coords, fe, device="cuda")
    clust = ctt.screening_series(coords, fe, nn.nh_dist,
                                 thresholds=[0.1, 0.2, ...], device="cuda")

All functions take and return numpy arrays.
"""

from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .ops import density as dops
from .ops import neighbors as nops
from .ops.screening import ThresholdSeriesScreener

Neighborhoods = namedtuple(
    "Neighborhoods", ["nh_idx", "nh_dist", "nhhd_idx", "nhhd_dist"])


def populations(coords, radius, device="cuda"):
    """Per-frame neighbour counts inside the hypersphere ``radius``
    (self-inclusive); an array for a scalar radius, else a dict radius ->
    array."""
    radii = np.atleast_1d(np.asarray(radius, dtype=float)).tolist()
    out = dops.populations(np.asarray(coords, np.float32), radii,
                           device=device)
    if np.ndim(radius) == 0:
        return out[radii[0]]
    return out


def free_energies(pops):
    """fe_i = -ln(pop_i / max pop)."""
    return dops.free_energies(pops)


def nearest_neighbors(coords, free_energy, device="cuda") -> Neighborhoods:
    """Joint nearest-neighbour and nearest-lower-free-energy search."""
    return Neighborhoods(*nops.nearest_neighbors(
        np.asarray(coords, np.float32), np.asarray(free_energy, np.float32),
        device=device))


def screening_series(coords, free_energy, nh_dist, thresholds,
                     device="cuda", hd_neighbors=None):
    """Density screening over a free-energy threshold series: one state
    trajectory per threshold (ids 1..K, 0 above it), seeded
    incrementally. ``hd_neighbors=(nn.nhhd_idx, nn.nhhd_dist)`` seeds new
    frames with their nearest-lower-fe edge (same results)."""
    thresholds = [np.float32(t) for t in thresholds]
    max_dist2 = np.float32(4.0 * nops.compute_sigma2(nh_dist))
    series = ThresholdSeriesScreener(
        np.asarray(coords, np.float32), np.asarray(free_energy, np.float32),
        thresholds, device=device, hd_neighbors=hd_neighbors)
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = [series.step_submit(k, max_dist2, pool)
                for k in range(len(thresholds))]
        return [f.result() for f in futs]
