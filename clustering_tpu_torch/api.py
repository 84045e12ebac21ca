"""High-level Python API of the PyTorch port (counterpart of
``clustering_tpu.api``):

    import clustering_tpu_torch as ctt

    pops = ctt.populations(coords, radius, device="cuda")
    fe = ctt.free_energies(pops)
    nn = ctt.nearest_neighbors(coords, fe, device="cuda")
    clust = ctt.screening_series(coords, fe, nn.nh_dist,
                                 thresholds=[0.1, 0.2, ...], device="cuda")
    micro = ctt.fill_landscape(clust[-1], nn, fe)    # seeded final states
    macro = ctt.mpp_lump(micro, fe, lagtime=25)      # MPP macrostates
    cored = ctt.core_trajectory(micro, windows=20)   # dynamical coring
    clean = ctt.assign_noise(micro, clust[-1], cmin=0.1)

All functions take and return numpy arrays. The last five run on the host
(the port's own copies of the JAX package's host models) and take no
device. The device stages take the JAX package's ``mesh=``, either kind
that ``parallel.make_mesh()`` builds: in a plain process a mesh over every
visible card (or over ``devices=[...]``), whose shares this process
launches and merges; inside an initialised process group the mesh of its
ranks' devices (one or several per rank), each rank calling with the
same arguments. Either way the caller gets the whole result, and the
device defaults to the mesh's (primary) one.
"""

from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .models import coring as _coring
from .models import density as _density
from .models import mpp as _mpp
from .models import noise as _noise
from .ops import density as dops
from .ops import neighbors as nops
from .ops.screening import ThresholdSeriesScreener

Neighborhoods = namedtuple(
    "Neighborhoods", ["nh_idx", "nh_dist", "nhhd_idx", "nhhd_dist"])

MppResult = namedtuple(
    "MppResult", ["trajectories", "transitions", "qmin_values"])


def _device(device, mesh):
    """``device``, else the mesh's primary device, else "cuda"."""
    if device is not None:
        return device
    return "cuda" if mesh is None else mesh.device


def populations(coords, radius, device=None, mesh=None):
    """Per-frame neighbour counts inside the hypersphere ``radius``
    (self-inclusive); an array for a scalar radius, else a dict radius ->
    array."""
    radii = np.atleast_1d(np.asarray(radius, dtype=float)).tolist()
    out = dops.populations(np.asarray(coords, np.float32), radii,
                           device=_device(device, mesh), mesh=mesh)
    if np.ndim(radius) == 0:
        return out[radii[0]]
    return out


def free_energies(pops):
    """fe_i = -ln(pop_i / max pop)."""
    return dops.free_energies(pops)


def nearest_neighbors(coords, free_energy, device=None,
                      mesh=None) -> Neighborhoods:
    """Joint nearest-neighbour and nearest-lower-free-energy search."""
    return Neighborhoods(*nops.nearest_neighbors(
        np.asarray(coords, np.float32), np.asarray(free_energy, np.float32),
        device=_device(device, mesh), mesh=mesh))


def screening_series(coords, free_energy, nh_dist, thresholds,
                     device=None, hd_neighbors=None, mesh=None):
    """Density screening over a free-energy threshold series: one state
    trajectory per threshold (ids 1..K, 0 above it), seeded
    incrementally. ``hd_neighbors=(nn.nhhd_idx, nn.nhhd_dist)`` seeds new
    frames with their nearest-lower-fe edge (same results)."""
    thresholds = [np.float32(t) for t in thresholds]
    max_dist2 = np.float32(4.0 * nops.compute_sigma2(nh_dist))
    series = ThresholdSeriesScreener(
        np.asarray(coords, np.float32), np.asarray(free_energy, np.float32),
        thresholds, device=_device(device, mesh), hd_neighbors=hd_neighbors,
        mesh=mesh)
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = [series.step_submit(k, max_dist2, pool)
                for k in range(len(thresholds))]
        return [f.result() for f in futs]


def fill_landscape(clustering, neighborhoods, free_energy):
    """Assign every unclustered frame to its nearest higher-density
    neighbor's state and rename states by decreasing population (the
    reference's seeded final density pass, ``density -i``)."""
    filled = _density.assign_low_density_frames(
        clustering, neighborhoods.nhhd_idx, free_energy)
    return _density.sorted_cluster_names(filled)


def mpp_lump(trajectory, free_energy, lagtime, qmin_values=None,
             concat_limits=None) -> MppResult:
    """Most-Probable-Path lumping over a Q_min series.

    Returns per-Q_min lumped trajectories plus the accumulated lumping
    transitions {from_state: (to_state, qmin)}."""
    traj = np.asarray(trajectory, dtype=np.int64)
    if qmin_values is None:
        qmin_values = np.round(np.arange(0.01, 1.0001, 0.01), 4)
    names = np.unique(traj).tolist()
    counts = _mpp.transition_counts(traj, concat_limits or [len(traj)],
                                    lagtime)
    tmat = _mpp.row_normalized(counts, names)
    trajectories = []
    transitions = {}
    current = traj
    for q in qmin_values:
        current, lumping, tmat = _mpp.fixed_metastability_clustering(
            current, tmat, float(q), np.asarray(free_energy, np.float32))
        trajectories.append(current)
        for frm, to in lumping.items():
            transitions[frm] = (to, float(q))
    return MppResult(trajectories, transitions, list(qmin_values))


def core_trajectory(trajectory, windows, concat_limits=None,
                    iterative=False):
    """Dynamical coring: a frame enters a new state's core only after
    ``windows`` consecutive frames of that state. ``windows`` is an int or
    a {state: window} dict. Returns (cored_trajectory, cores) where cores
    is -1 outside core regions."""
    traj = np.asarray(trajectory, dtype=np.int64)
    if isinstance(windows, dict):
        wmap, size_for_all = windows, 1
    else:
        wmap, size_for_all = {}, int(windows)
    cored, cores, _ = _coring.core_trajectory(
        traj, concat_limits or [len(traj)], wmap, size_for_all, iterative)
    return cored, cores


def assign_noise(trajectory, highest_clustering, cmin=0.1,
                 concat_limits=None):
    """Mark frames of clusters below the ``cmin`` population percentage as
    noise and dynamically reassign them to the previous core."""
    traj = np.asarray(trajectory, dtype=np.int64)
    marked, noise_state, _ = _noise.noise_assignment(
        traj, highest_clustering, 0.01 * float(cmin))
    out, cores, _ = _noise.reassign_noise(
        marked, noise_state, concat_limits or [len(traj)], traj)
    return out


def waiting_time_distribution(trajectory, state):
    """P(streak >= t) of consecutive-frame streaks of ``state``."""
    traj = np.asarray(trajectory, dtype=np.int64)
    if not len(traj):
        return _coring.compute_wtd([])
    change = np.flatnonzero(traj[1:] != traj[:-1]) + 1
    bounds = np.concatenate(([0], change, [len(traj)]))
    lengths = np.diff(bounds)
    streaks = lengths[traj[bounds[:-1]] == state]
    return _coring.compute_wtd(streaks)
