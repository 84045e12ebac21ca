"""Density-clustering mode driver on PyTorch.

Counterpart of ``clustering_tpu/models/density.py::main``: the same flags,
artifact files and restart/reuse behaviour (-r/-R, the lumping radius when
-r is absent, -D/-B/-i reuse, the -T screening series), with the O(N^2)
stages on the engines of :mod:`clustering_tpu_torch.ops`. The pure-numpy
helpers are copies of the JAX module's: it imports its ``ops`` package and
through it jax.

The run meshes as the JAX CLI does (:func:`run_mesh`): inside a process
group (the CLI has joined one, ``parallel.mesh.initialize``) over every
rank's devices -- all of its host's visible cards for a rank alone on
its host, else one card of its own (the host rule,
``parallel.mesh.host_devices``) -- each rank writing the same files in
its own working directory; else over every visible card when there is
more than one, from this one process, which writes each file once; else
on one device.

When nearest neighbours follow populations, populations starts the NN
band pass (``nn_band_radius``) and the screening series' screener is
built on the write pool while NN runs, its lower-fe edges attached after
it, as in the JAX CLI; on a mesh both stay on the main thread and every
stage is dealt over the mesh's devices.
``CLUSTERING_TPU_PROFILE_SUBSTAGES`` adds each device stage's sub-stage
times to the ``-v`` log.

Spans (``utils.timer``): on the main thread ``density.setup`` (the mesh
and the engine), the four stage timers, ``cli.write_wait`` wherever the
main thread waits on writes and ``cli.teardown``; on the workers, each
in a thread of its own name, the writes (``io.write``, pools "write" and
"io"), the screener's build (``screener.build``, pool "write"), the
screening steps' postludes (``screening.post``, pool "post") and the
warms (``warm.pops`` and ``warm.nn`` on thread "warm-stages",
``warm.screen_early`` and ``warm.screen``), each the child of the span
that handed it over.

On a CUDA device without a mesh, daemon threads pay each stage's
first-use costs ahead of it, where the JAX CLI warms its compiles: the
engine's ``precompile_pops`` and ``precompile_nn`` once the engine
exists, the screener's ``precompile`` during NN from the band pass's
sigma^2 estimate (``CLUSTERING_TPU_EARLY_SCREEN_WARM=0`` turns that one
off) and after NN at the real linking distance.
``CLUSTERING_TPU_PRECOMPILE=0`` turns them all off. The warms run on
scratch engines of their own, so the files are the same either way.
"""

import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch.distributed as dist

from ..parallel import mesh as pmesh
from ..utils import io
from ..utils.logger import logger
from ..ops import density as dops
from ..ops import neighbors as nops
from ..ops.engine import DensityEngine, warm_failed, warm_on
from ..ops.screening import ScreeningEngine, ThresholdSeriesScreener
from ..utils.timer import adopt, carried, last, span, stage_timer


def _die(msg):
    print(msg, file=sys.stderr)
    sys.exit(1)


def has_2_digits(val) -> bool:
    """float-precision two-decimal check (reference: density_clustering.cpp:500-504)."""
    f = np.float32(val)
    truncated = np.float32(int(np.float32(f * np.float32(100.0))) / 100.0)
    return bool(truncated == f)


def sorted_fe_order(free_energy) -> np.ndarray:
    """FE-ascending frame order; stable on ties."""
    return np.argsort(np.asarray(free_energy), kind="stable")


def assign_low_density_frames(clustering, nhhd_idx, free_energy):
    """Assign unclustered frames to their nearest higher-density neighbour's
    cluster (pointer jumping along the acyclic higher-density chain)."""
    c = np.asarray(clustering, dtype=np.int64).copy()
    nhhd = np.asarray(nhhd_idx, dtype=np.int64)
    n = len(c)
    ptr = np.where(c > 0, np.arange(n, dtype=np.int64), nhhd)
    while True:
        nxt = ptr[ptr]
        if np.array_equal(nxt, ptr):
            break
        ptr = nxt
    resolved = c[ptr]
    return np.where(c > 0, c, resolved)


def sorted_cluster_names(clustering):
    """Rename states by decreasing population: most populated -> 1; ties
    give the smaller original id the larger new name."""
    c = np.asarray(clustering, dtype=np.int64)
    vals, inverse, counts = np.unique(c, return_inverse=True,
                                      return_counts=True)
    order = np.argsort(counts, kind="stable")
    k = len(vals)
    new_name = np.empty(k, dtype=np.int64)
    new_name[order] = k - np.arange(k)
    return new_name[inverse]


def normalized_cluster_names(n_below, clustering, order):
    """Rename cluster labels to 1..K by ascending raw label over the
    below-threshold frames; 0 stays 0."""
    c = np.asarray(clustering, dtype=np.int64)
    prefix_names = np.unique(c[order[:n_below]])
    prefix_names = prefix_names[prefix_names != 0]
    lookup = np.zeros(int(c.max()) + 1 if len(c) else 1, dtype=np.int64)
    for new, old in enumerate(prefix_names, start=1):
        lookup[old] = new
    return lookup[c]


def screening_step(free_energy, nh_dist, threshold, coords, prev_clustering,
                   order=None, coords_sorted=None, engine=None,
                   incremental=False, device="cuda"):
    """One screening threshold: returns the normalized clustered
    trajectory (the JAX package's ``screening_step``).

    ``order`` / ``coords_sorted`` may be passed to re-use the FE sort across
    thresholds of a screening series, and ``engine`` (a
    :class:`ScreeningEngine` over ``coords_sorted``) its upload;
    ``device`` serves only when ``engine`` is None. ``incremental=True``
    asserts that ``prev_clustering`` is the previous threshold's fixpoint
    at the same linking distance (true inside a -T series), enabling
    new-edges-only sweeps.
    """
    fe = np.asarray(free_energy, dtype=np.float32)
    n = len(fe)
    if order is None:
        order = sorted_fe_order(fe)
    if coords_sorted is None:
        coords_sorted = np.asarray(coords, dtype=np.float32)[order]
    # number of frames with fe <= threshold (std::upper_bound semantics)
    fe_sorted = fe[order]
    n_below = int(np.searchsorted(fe_sorted, np.float32(threshold),
                                  side="right"))
    max_dist2 = np.float32(4.0 * nops.compute_sigma2(nh_dist))
    logger("    %6s %9i" % ("%.2f" % threshold, n_below))
    prev = (np.zeros(n, dtype=np.int64) if prev_clustering is None
            else np.asarray(prev_clustering, dtype=np.int64))
    prev_sorted = prev[order]
    prev_sorted[n_below:] = 0
    # first not-yet-clustered frame in FE order
    zeros = np.flatnonzero(prev_sorted == 0)
    prev_last = int(zeros[0]) if len(zeros) else n
    if prev_last >= n_below:
        # nothing new below this threshold: keep the previous clustering
        return prev.copy()
    # initial labels as frame pointers in sorted space: seeded frames point
    # to the first occurrence of their seed label, new frames to themselves
    labels0 = np.arange(n, dtype=np.int64)
    prefix = prev_sorted[:n_below]
    seeded = prefix != 0
    if seeded.any():
        vals, first_idx = np.unique(prefix[seeded], return_index=True)
        seeded_pos = np.flatnonzero(seeded)
        first_occ = seeded_pos[first_idx]
        labels0[seeded_pos] = first_occ[
            np.searchsorted(vals, prefix[seeded])]
    if engine is None:
        engine = ScreeningEngine(coords_sorted, device=device)
    row_lo = prev_last if incremental else 0
    final = engine.run(labels0.astype(np.int32), n_below, max_dist2,
                       row_lo=row_lo)
    clustering = np.zeros(n, dtype=np.int64)
    clustering[order[:n_below]] = final[:n_below].astype(np.int64) + 1
    return normalized_cluster_names(n_below, clustering, order)


def _parse_threshold_series(params, free_energy):
    """-T FROM STEP TO -> the threshold list, with the reference's fp32
    loop arithmetic. Raises ValueError on usage errors."""
    if len(params) > 3:
        raise ValueError("error: option -T expects at most three floating"
                         " point arguments: FROM STEP TO.")
    t_from = np.float32(0.1)
    t_step = np.float32(0.1)
    t_to = np.float32(np.max(free_energy))
    if len(params) >= 1 and params[0] >= 0.0:
        t_from = np.float32(params[0])
    if len(params) >= 2:
        t_step = np.float32(params[1])
    if len(params) == 3:
        t_to = np.float32(params[2])
    if not (has_2_digits(t_from) and has_2_digits(t_step)):
        raise ValueError("error: -T can handle at maximum two digits.")
    t_to_low = np.float32(t_to - t_step / np.float32(10.0) + t_step)
    t_to_high = np.float32(t_to + t_step / np.float32(10.0) + t_step)
    thresholds = []
    t = t_from
    while (t < t_to_low) and not (t_to_high < t):
        thresholds.append(np.float32(t))
        t = np.float32(t + t_step)
    return t_from, t_step, t_to, thresholds


def _check_backends(coords, kind, got, radii=None, fe=None, device="cpu"):
    """--check mode: recompute with the dense plain versions on ``device``
    and report how many entries disagree with the kernels' route (the
    JAX package compares its Pallas route with its XLA route)."""
    n = len(coords)
    if kind == "pops":
        other = dops.populations_dense(coords, radii, device=device)
        bad = sum(int((got[r] != other[r]).sum()) for r in radii)
        total = n * len(radii)
    else:
        other = nops.nearest_neighbors_dense(coords, fe, device=device)
        bad = int((got[0] != other[0]).sum() + (got[2] != other[2]).sum())
        total = 2 * n
    frac = bad / max(total, 1)
    logger(f"    [check] {kind}: {bad}/{total} entries differ between"
           " backends")
    if frac > 0.01:
        _die(f"error: --check failed for {kind}:"
             f" {frac:.2%} of entries disagree between backends")


def _log_substages(engine, stage_key, extra=None):
    """Verbose sub-stage walls (``t_plan``, ``t_band``, ``t_sweep`` ...)
    of the engine's last ``stage_key`` stage, and those of ``extra`` if
    given, when CLUSTERING_TPU_PROFILE_SUBSTAGES is set."""
    if not os.environ.get("CLUSTERING_TPU_PROFILE_SUBSTAGES"):
        return
    st = dict(engine.last_stats.get(stage_key, {}), **(extra or {}))
    parts = ", ".join(f"{k}={v:.3f}" for k, v in st.items()
                      if isinstance(v, float) and k.startswith("t_"))
    if parts:
        logger(f"      [{stage_key} substages: {parts}]")


def _build_screener(coords, free_energy, thresholds, device, morton_order,
                    parent):
    """The series screener without lower-fe edges, built (on a worker
    thread) under the span ``parent``."""
    with adopt(parent):
        return ThresholdSeriesScreener(coords, free_energy, thresholds,
                                       device=device,
                                       morton_order=morton_order)


def _precompile_on(engine):
    """Whether the warm threads run: where the warms do
    (``ops.engine.warm_on``), unless CLUSTERING_TPU_PRECOMPILE is "0"."""
    return (warm_on(engine.device, engine.mesh)
            and os.environ.get("CLUSTERING_TPU_PRECOMPILE") != "0")


def run_mesh(device):
    """The density run's mesh, by the JAX CLI's rule: the process group's
    when one is initialised, this rank on the host rule's devices of
    ``device``'s type (``parallel.mesh.rank_devices``: every visible one
    when the rank is alone on its host, else one of its own); else, when
    more than one device is visible for ``device``
    (``parallel.mesh.visible_devices``: every card for a bare "cuda"), a
    local mesh over all of them; else None."""
    if dist.is_initialized():
        return pmesh.make_mesh(devices=pmesh.rank_devices(device))
    devices = pmesh.visible_devices(device)
    return pmesh.make_mesh(devices=devices) if len(devices) > 1 else None


def main(args, header_comment, comments_map, device):
    """density mode on ``device``, or on the mesh of :func:`run_mesh`."""
    coords = io.read_coords(args.file)
    free_energy = None
    # the pops / fe / nn files are written on worker threads while the
    # next stage computes, and the screener is built beside the NN stage
    # (a third worker, so that it does not queue behind the two writes);
    # every write is joined before the end
    write_pool = ThreadPoolExecutor(max_workers=3, thread_name_prefix="write")
    deferred_writes = []
    warms = []
    engine = None

    def warm(name, fn, parent=None):
        """Run ``fn()`` on a daemon thread ``name``, under ``parent``
        (default: the span open here), joined before the end."""
        if _precompile_on(engine):
            warms.append(threading.Thread(target=carried(fn, parent),
                                          name=name, daemon=True))
            warms[-1].start()

    def _defer_write(fn, path, data, parent):
        snap = dict(comments_map)
        deferred_writes.append(write_pool.submit(
            carried(fn, parent), path, data, header_comment, snap))

    # which stages run, decided once: the populations stage; within it,
    # without -r and -R, an NN run for the lumping radius; after it, an NN
    # stage, whose band pass populations starts
    pops_stage = not args.free_energy_input and (
        args.free_energy or args.population or args.output)
    nn_for_lump = not args.radii and args.radius is None
    nn_after_pops = (not args.nearest_neighbors_input and not args.radii
                     and not args.input
                     and (args.nearest_neighbors or args.output))
    # the warms: not with -i, nor the NN warm with -B
    warm_pops = pops_stage and not args.input
    warm_nn = nn_after_pops or (nn_for_lump and not args.input
                                and not args.nearest_neighbors_input)
    radii = (list(args.radii) if args.radii
             else [1.0 if args.radius is None else float(args.radius)])

    def stage_warms():
        # one thread: the warms' host work would only contend for the
        # interpreter lock with each other and with the stages
        if warm_pops:
            with span("warm.pops"):
                engine.precompile_pops(radii)
        if warm_nn:
            with span("warm.nn"):
                engine.precompile_nn()

    try:
        with span("density.setup"):
            mesh = run_mesh(device)
            if mesh is not None:
                device = mesh.device
                # this process's devices
                logger(f"~~~ mesh of {mesh.size} devices: "
                       + ", ".join(map(str, mesh.devices)))
            engine = DensityEngine(coords, device=device, mesh=mesh)
            if warm_pops or warm_nn:
                warm("warm-stages", stage_warms)
        free_energy = _free_energy_stage(args, engine, comments_map,
                                         _defer_write, pops_stage,
                                         nn_for_lump, nn_after_pops)
        nh, series_fut = _nn_stage(args, engine, free_energy, comments_map,
                                   header_comment, write_pool,
                                   deferred_writes, warm)
        if args.output:
            _cluster_stage(args, coords, free_energy, nh, comments_map,
                           header_comment, device, mesh, series_fut, warm,
                           engine.layout_order("morton"))
        with span("cli.write_wait"):
            for fut in deferred_writes:
                fut.result()
    finally:
        with span("cli.teardown"):
            write_pool.shutdown()
            for thread in warms:
                thread.join()
    logger("~~~ freeing memory")


def _device_warm_seconds():
    """``t_device_warm`` for the populations sub-stage line: the CLI's
    ``cli.device_warm`` span, if it ended without an error."""
    warm = last("cli.device_warm")
    return None if warm is None else {"t_device_warm": warm.seconds}


def _free_energy_stage(args, engine, comments_map, defer_write, pops_stage,
                       nn_for_lump, nn_after_pops):
    """The free energies of -D, or populations and free energies at the -r
    radius (or the lumping radius), or at each -R radius (returns None);
    the last three arguments are ``main``'s decisions."""
    if args.input and (args.free_energy or args.nearest_neighbors):
        _die("error: for input (-i) -D/-B should be used.")
    logger("~~~ free energy and population")
    if args.free_energy_input:
        logger("    re-using free energy: " + args.free_energy_input)
        if args.radii or args.radius is not None:
            logger("warning: radius (-r/-R) is ignored")
        if args.free_energy or args.population:
            logger("warning: -p/-d flags are ignored")
        free_energy = io.read_free_energies(args.free_energy_input)
        io.read_comments(args.free_energy_input, comments_map)
        return free_energy
    if not pops_stage:
        return None
    if nn_for_lump:
        # no radius: the lumping radius from NN statistics
        logger("    computing lumping radius")
        pops = engine.populations([1.0], nn_band_radius=1.0)[1.0]
        _, nh_dist, _, _ = engine.nearest_neighbors(dops.free_energies(pops))
        sigma2 = nops.compute_sigma2(nh_dist)
        radius_lump = float(np.sqrt(np.float32(4.0 * sigma2)))
        logger("        d_lump=" + io.fmt_float(radius_lump))
        comments_map["lumping_radius"] = radius_lump
        radius = radius_lump
    elif not args.radii:
        radius = float(args.radius)
    logger("    calculating free energy and population")
    scan = bool(args.radii)
    if scan:
        if args.output:
            _die("error: clustering cannot be done with several radii"
                 " (-R is set).")
        if not (args.population or args.free_energy):
            _die("error: no output defined for populations or free"
                 " energies.\n       why did you define -R ?")
        radii = list(args.radii)
        logger("    using radii: " + ", ".join(str(r) for r in radii))
    else:
        logger("    using radius: " + io.fmt_float(radius))
        comments_map["clustering_radius"] = radius
        radii = [radius]
    with stage_timer("populations") as stage:
        pops_map = engine.populations(
            radii, nn_band_radius=radii[0] if nn_after_pops else None)
    _log_substages(engine, "populations", _device_warm_seconds())
    if args.check:
        _check_backends(engine.coords, "pops", pops_map, radii=radii,
                        device=engine.device)

    def path(name, radius):  # -R: a file per radius
        return io.stringprintf(name + "_%f", radius) if scan else name

    if scan:
        logger("    storing results")
    # the populations' writes start first, and the free energies are
    # computed while they run
    if args.population:
        if not scan:
            logger("    storing population in: " + args.population)
        for radius in sorted(pops_map):
            defer_write(io.write_pops, path(args.population, radius),
                        pops_map[radius], stage)
    if args.free_energy and not scan:
        logger("    storing free energy in: " + args.free_energy)
    if scan and not args.free_energy:
        return None
    with span("density.free_energies", radii=len(pops_map)):
        for radius in sorted(pops_map):
            free_energy = dops.free_energies(pops_map[radius])
            if args.free_energy:
                defer_write(io.write_fes, path(args.free_energy, radius),
                            free_energy, stage)
    return None if scan else free_energy


def _nn_stage(args, engine, free_energy, comments_map, header_comment,
              write_pool, deferred_writes, warm):
    """(the neighbourhoods, the Future of the screener built meanwhile or
    None); ``warm`` starts a warm thread (``main``)."""
    logger("\n~~~ nearest neighbors")
    if args.nearest_neighbors_input:
        logger("    re-using nearest neighbor: "
               + args.nearest_neighbors_input)
        nh = io.read_neighborhood(args.nearest_neighbors_input)
        io.read_comments(args.nearest_neighbors_input, comments_map)
        return nh, None
    if not (args.nearest_neighbors or args.output):
        return None, None
    if args.radii:
        _die("error: nearest neighbor calculation cannot be done with\n"
             "       several radii (-R is set).")
    if free_energy is None:
        _die("error: nearest-neighbor search requires free energies"
             " (-d/-p/-o or -D).")
    logger("    calculating nearest neighbors")
    with stage_timer("nearest neighbors") as stage:
        series_fut = _start_screener(args, engine, free_energy, write_pool,
                                     warm, stage)
        nh = engine.nearest_neighbors(free_energy)
    _log_substages(engine, "nn")
    if args.check:
        _check_backends(engine.coords, "nn", nh, fe=free_energy,
                        device=engine.device)
    if comments_map["lumping_radius"] == 0.0:
        sigma2 = nops.compute_sigma2(nh[1])
        radius_lump = float(np.sqrt(np.float32(4.0 * sigma2)))
        logger("    lumping radius: " + io.fmt_float(radius_lump))
        comments_map["lumping_radius"] = radius_lump
    if args.nearest_neighbors:
        logger("    storing nearest neighbors in: " + args.nearest_neighbors)
        deferred_writes.append(write_pool.submit(
            carried(io.write_neighborhood, stage), args.nearest_neighbors,
            nh[0], nh[1], nh[2], nh[3],
            io.append_comments_map(header_comment, comments_map)))
    return nh, series_fut


def _start_screener(args, engine, free_energy, write_pool, warm, stage):
    """The Future of the series screener, built on the write pool while NN
    runs (it depends on (coords, fe, thresholds) alone), with the early
    screening warm; None on a mesh (uploads from a worker thread could
    race the collectives: the screening stage builds it) or without a
    series. ``stage`` is the NN stage's span, the build's parent."""
    if (engine.mesh is not None or not args.output
            or args.threshold_screening is None or args.input):
        return None
    try:
        thresholds = _parse_threshold_series(
            list(args.threshold_screening), free_energy)[3]
    except ValueError:
        return None  # the screening stage reports it
    # the engine's Morton order, read here: the worker must not build
    # the engine's layouts
    series_fut = write_pool.submit(_build_screener, engine.coords,
                                   free_energy, thresholds, engine.device,
                                   engine.layout_order("morton"), stage)
    if os.environ.get("CLUSTERING_TPU_EARLY_SCREEN_WARM") != "0":
        # the screening warm during NN, at the linking distance estimated
        # from the prefetched band pass
        def early_screen_warm():
            with span("warm.screen_early"):
                try:
                    est = engine.band_sigma2_estimate()
                    if est is not None:
                        series_fut.result().precompile(
                            np.float32(4.0 * est), compile_only=True)
                except Exception as exc:  # the stages raise it themselves
                    warm_failed("early screening warm", exc)
        warm("warm-screen-early", early_screen_warm)
    return series_fut


def _cluster_stage(args, coords, free_energy, nh, comments_map,
                   header_comment, device, mesh, series_fut=None,
                   warm=None, morton_order=None):
    if args.radii:
        _die("error: output needs to depend on single radius\n"
             "       but several radii (-R) are set.")
    if args.input:
        logger("~~~ generating microstates")
        if args.threshold_screening:
            logger("warning: screening (-T) is ignored")
        logger("    reading initial states: " + args.input)
        clustering = io.read_clustered_trajectory(args.input)
        io.read_comments(args.input, comments_map)
        logger("    assigning low density states to initial states")
        clustering = assign_low_density_frames(clustering, nh[2],
                                               free_energy)
        logger("    sorting and renaming states by decreasing population")
        clustering = sorted_cluster_names(clustering)
        logger("    storing states in: " + args.output)
        io.write_clustered_trajectory(args.output, clustering,
                                      header_comment, comments_map)
        return
    if args.threshold_screening is None:
        _die("error: one of -T/-i is needed to generate output.")
    logger("\n~~~ free energy screening")
    try:
        t_from, t_step, t_to, thresholds = _parse_threshold_series(
            list(args.threshold_screening), free_energy)
    except ValueError as exc:
        _die(str(exc))
    comments_map["screening_to"] = float(t_to)
    comments_map["screening_from"] = float(t_from)
    comments_map["screening_step"] = float(t_step)
    logger("\n        fe    frames")
    sigma2 = nops.compute_sigma2(nh[1])
    max_dist2 = np.float32(4.0 * sigma2)
    with stage_timer("screening setup") as setup:
        if series_fut is None:
            series = ThresholdSeriesScreener(coords, free_energy, thresholds,
                                             device=device,
                                             hd_neighbors=(nh[2], nh[3]),
                                             mesh=mesh,
                                             morton_order=morton_order)
        else:
            series = series_fut.result()
            series.set_hd_neighbors((nh[2], nh[3]))
    if series_fut is not None:
        logger(f"    [screener built during nearest neighbors in"
               f" {series.build_seconds:.3f}s]")
    if warm is not None:
        def screen_warm():
            with span("warm.screen"):
                series.precompile(max_dist2)
        warm("warm-screen", screen_warm, setup)
    # each step's label download + naming and its file write overlap the
    # next threshold's sweeps
    with ThreadPoolExecutor(max_workers=2,
                            thread_name_prefix="post") as post_pool, \
            ThreadPoolExecutor(max_workers=2,
                               thread_name_prefix="io") as io_pool:
        pending = []
        for k, tk in enumerate(thresholds):
            logger("    %6s %9i" % ("%.2f" % tk,
                                    int(series.n_below_per_band[k])))
            with stage_timer("screening %.2f" % tk) as step:
                fut = series.step_submit(k, max_dist2, post_pool)
            path = io.stringprintf(args.output + ".%0.2f", float(tk))
            pending.append(io_pool.submit(carried(
                lambda f=fut, p=path: io.write_clustered_trajectory(
                    p, f.result(), header_comment, comments_map), step)))
        with span("cli.write_wait"):
            for fut in pending:
                fut.result()
