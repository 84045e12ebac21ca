#!/usr/bin/env python3
"""Smoke run of the PyTorch port (clustering_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: compile the CUDA kernels from csrc/ with nvcc;
  3. each kernel against its plain PyTorch version on the card at
     N = 2^16, D = 4, on the tile lists the two paths plan there (the
     upper-triangular lists for the bidirectional kernels; the full
     populations plane, the band without closure and the full screening
     list, all columns dirty and a dirty subset, for the row-side
     kernels; for those also a shuffled list each, the phase-2 call of the
     symmetric NN search, whose rows start from the band pass's keys, and
     the labels of a finished symmetric fixpoint, where the label-min
     kernel's step skip fires) and, for the dense-grid kernels, on the
     Morton layout's skip words (radius words for ``pops_tiles``; band
     words, then the band's bound words, for ``nn_tiles``), and the three
     counting kernels once more with three radii (``pops_bidir`` and
     ``pops_sparse`` under a random partial rmask): counts, ids and labels
     exact, distances bit-equal;
  4. the density CLI on cuda with ``--check`` against the same CLI on cpu
     without it at N = 2^15: the check must pass (its counts are
     printed); pop, fe and clust.* files identical, nn ids identical, nn
     distances bit-equal or within one unit of the last printed digit;
  5. the main path at N = 2^20, D = 4: ``density -r 0.1 -T 0.5 0.5 2.0``
     through the port's CLI, with its stage walls and sub-stage times, the
     launch count of every bidirectional kernel (each must be > 0) and
     output invariants; its ``-v`` log must show the NN stage taking the
     band pass that populations started and the screener built during
     NN, and its pop, nn and clust.* data lines must equal those of the
     pipeline before (block-bound NN without prefetch, the screener built
     after NN) on the coordinates it read;
  6. the symmetric path at N = 2^20, D = 4, r = 0.1, thresholds
     0.5/1.0/1.5/2.0: populations -> free energies -> nearest neighbours
     -> screening series through the engines, once with the bidirectional
     switches on and once with them off (``POPS_BIDIR``, ``NN_BIDIR``,
     ``BIDIR``); populations, nn ids, nn distances (bit for bit) and every
     clustering must be identical, every row-side kernel launched in the
     symmetric run and no bidirectional one, every stage of both runs
     planned on the device. Each run pipelines as the CLI does (band
     prefetch, the screener built during NN); NN takes the auto rule's
     phase 2 on the bidirectional run and the tiered one on
     the symmetric run (``nn_sparse`` on a row-only tiered list), and
     once more block-bound (``tier_check``), which must give the same
     neighbours bit for bit; after the bidirectional run, the plan check
     (each device planner's tile list against the numpy planners' on the
     same masks, identical, with both planners' times);
  7. the skip-word route at N = 2^20, D = 4, r = 0.1, as the library
     functions ``pops_tiles`` and ``nn_tiles`` are meant to be composed:
     Morton layout, populations under radius skip words, free energies,
     then NN in two passes (a band pass; a pass under the band's
     per-row-block bounds, whose output alone is the answer). Populations,
     nn ids and nn distances (bit for bit) must equal phase 6's
     bidirectional run.

  8. every kernel on the calls its 2^20 path made (the bidirectional
     kernels: phase 5; the row-side ones: phase 6's symmetric run; the
     dense-grid ones: phase 7), recorded during those phases and replayed:
     kernel time (CUDA events, summed over the calls), its plain version
     on the same inputs (exact), launches, evaluated pairs and the bound,
     the larger of 3 D flops per pair over the FP32 peak and the bytes
     over the HBM rate, with the card's name and power limit;
  9. big N, the engines as in phase 6 on the default route at N = 2^24,
     the JAX package's largest (``bigN_check.py``'s ``BIG_N``): every
     stage must say it planned on the device and launch its
     bidirectional kernel; phase 5's output invariants; a sampled exact
     check of 256 frames against all N (populations, both neighbours, and
     the last clustering's label against every admissible neighbour's);
     phase 6's tier check and plan check. It prints the stage walls,
     t_plan, t_best_sort, the populations' host finish, the tier split,
     each kernel's time (CUDA events around its calls), launches,
     evaluated pairs and share of the FP32 bound, the peak of device
     memory per stage (the peak statistics reset as each stage starts)
     and the host's peak RSS;
 10. mesh (``clustering_tpu_torch.parallel``): phase 6's configuration
     through the engines on 2 and 4 gloo ranks sharing cuda:0 (spawned
     processes, a FileStore rendezvous, a join time limit), the switches
     on, then 2 ranks with them off. On every rank, populations, nn ids,
     nn distances (bit for bit) and the four clusterings must equal phase
     6's run of the same route, NN's phase 2 its mode (the row-side route
     stays block-bound on a mesh); each stage's per-rank shares must sum
     to phase 6's tile count and differ by at most one; each kernel of the
     route must launch on every rank with a non-empty share, and no other.
     Each rank runs twice, cold (first in its process) and warm. Then the
     density CLI at phase 5's argv in a process of its own, plain and
     under the distributed switches with NCCL at world size 1: both must
     write phase 5's files, byte for byte. It prints rank 0's stage walls,
     each rank's summed all_reduce seconds and its tile shares, and the
     CLI processes' walls.
 11. the JAX package's surface and the runtime switches:
     (a) the density CLI at phase 5's argv in fresh processes with the
     warms off (``CLUSTERING_TPU_DEVICE_WARM=0``,
     ``CLUSTERING_TPU_PRECOMPILE=0``), on, on, off: every run writes phase
     5's files; each prints its populations, NN and screening set-up walls
     and sub-stages; (b) one more such process under
     ``CLUSTERING_TPU_PROFILE``: phase 5's files again, and from its
     Chrome trace the window from the first stage annotation to the last,
     the device's busy seconds in it (the union of the CUDA kernel, memcpy
     and memset events), the idle share, in total and per stage, and the
     5 device ops with the most time; it fails without a CUDA kernel
     event, or without one of the three bidirectional kernels; (c)
     ``models.density.screening_step`` over phase 5's thresholds, the
     order, sorted coordinates and engine reused, ``incremental``, on
     phase 5's coordinates and neighbour distances (N_MAIN: under a
     second on the H100, where FE order prunes little): the four
     clusterings equal phase 5's files; (d) the unpruned route at N =
     2^16: ``populations(prune=False)`` through ``pops_sparse`` and
     ``nearest_neighbors(prune=False)`` (switches off) through
     ``nn_sparse``, equal to the pruned default route, each kernel
     launched and held against its plain version on those calls (exact);
     (e) run inside phase 6 on its bidirectional engines:
     ``precompile_pops``, ``precompile_nn`` and ``series.precompile``
     launch their stages' kernels, and populations, NN and the series
     after them equal phase 6's run.
 12. local mesh (``parallel.make_mesh(devices=[...])``, one process
     driving several devices; cuda:0 named k times on the one card): (a)
     phase 6's configuration through the engines on meshes of 2 and 4, on
     both routes: populations, nn ids, nn distances (bit for bit) and the
     four clusterings equal to phase 6's run of the route, NN's phase 2
     its mode (the row-side route stays block-bound on a mesh), each
     stage's shares (each device's own row blocks) summing to phase 6's
     tiles, and the route's kernels launched once per device per call with a
     non-empty share, no other; (b) run right after phase 8 on phase 5's
     recorded calls: ``pops_bidir``, ``nn_bidir`` and ``label_min_bidir``
     on share 1 of 2 of each call's list against their plain versions
     (exact); (c) the density CLI in this process at phase 5's argv, the
     visible devices (``parallel.mesh.visible_devices``) patched to cuda:0
     twice: it meshes them and writes phase 5's files, byte for byte; (d)
     the engines at N = 2^24 on a mesh of 2: phase 9's results bit for
     bit, its invariants and sampled exact check, and the peak device
     memory; (e) where ``nvidia-smi -L`` lists more than one card, the
     CLI in a process of its own over two real cards against phase 5's
     files, else a line that says why it did not run. It prints the stage
     walls, the merges' seconds (each between two synchronizes) and the
     shares. Co-located devices share one card: the walls are overheads.
 13. group mesh (a process group whose ranks each drive several devices,
     the JAX package's multi-process mesh): (a) 2 gloo ranks sharing
     cuda:0, each with ``make_mesh(devices=["cuda:0"] * 2)``, phase 6's
     configuration on both routes: on every rank populations, nn ids, nn
     distances (bit for bit) and the four clusterings equal phase 6's run,
     each device's shares equal to phase 12's mesh of 4 at its global
     index, the route's kernels launched once per device per call with a
     non-empty share, no other; (b) the density CLI in a process of its
     own under the distributed switches at world size 1 with NCCL, its
     visible devices patched to cuda:0 twice: it meshes both and writes
     phase 5's files, byte for byte; (c) where ``nvidia-smi -L`` lists two
     or more cards, (b) unpatched over two real cards, else a line that
     says why not. It prints rank 0's stage walls, each rank's merges and
     ``all_reduce`` seconds, and the CLI process's walls.
 14. the top of the users' range through the CLI: ``synthetic_fel`` at N
     = 10^7 (not a multiple of the blocks, so the padding runs at scale),
     written as ``%.6f`` text by the port's native formatter (its first
     rows byte-equal to ``np.savetxt``'s), then phase 5's argv in this
     process: exit 0, 10^7 data lines in pop, fe, nn and each clust.*
     (read back with the port's native readers), phase 5's invariants,
     the sampled exact check of 256 frames on the neighbours the CLI's
     engine returned, the three bidirectional kernels launched and the
     populations finished by the native pass. It prints the stage walls,
     the text I/O's seconds, the peak of device memory and the host's
     peak RSS.

The line before the last holds the kernels' JSON record, from phase 8;
the last line is {"ok": true, "device": {...}}. It imports nothing of JAX
and nothing of the JAX package.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import tempfile
import time

import numpy as np

N_KERNELS = 1 << 16
N_SLICE = 1 << 15
N_MAIN = 1 << 20
DIM = 4
RADIUS = 0.1
ARGV = ["density", "-f", "coords.dat", "-r", str(RADIUS), "-p", "pop",
        "-d", "fe", "-b", "nn", "-o", "clust", "-T", "0.5", "0.5", "2.0",
        "-v"]
THRESHOLDS = ("0.50", "1.00", "1.50", "2.00")
SUBSTAGES_ENV = "CLUSTERING_TPU_PROFILE_SUBSTAGES"
KERNELS = {
    "pops_bidir": "clustering_tpu/ops/pallas_kernels.py:291",
    "nn_bidir": "clustering_tpu/ops/pallas_kernels.py:1091",
    "label_min_bidir": "clustering_tpu/ops/pallas_kernels.py:1383",
    "pops_sparse": "clustering_tpu/ops/pallas_kernels.py:191",
    "nn_sparse": "clustering_tpu/ops/pallas_kernels.py:982",
    "label_min_sparse": "clustering_tpu/ops/pallas_kernels.py:1275",
    "pops_tiles": "clustering_tpu/ops/pallas_kernels.py:114",
    "nn_tiles": "clustering_tpu/ops/pallas_kernels.py:622",
}
BIDIR_KERNELS = ("pops_bidir", "nn_bidir", "label_min_bidir")
SPARSE_KERNELS = ("pops_sparse", "nn_sparse", "label_min_sparse")
TILES_KERNELS = ("pops_tiles", "nn_tiles")


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def synthetic_fel(n, d, seed=0):
    """Metastable Markov walk between anisotropic gaussian basins
    (temporally correlated frames, like MD data); bench.py's generator."""
    rng = np.random.default_rng(seed)
    centers = np.asarray([
        [0.0, 0.0, 0.0, 0.0],
        [1.1, 0.4, -0.2, 0.1],
        [-0.8, 1.0, 0.3, -0.2],
        [0.5, -0.9, 0.1, 0.3],
    ])[:, :d]
    n_basins = len(centers)
    scales = np.linspace(0.25, 0.08, d)
    stay = 0.9995
    jumps = rng.random(n) > stay
    basin = np.cumsum(jumps)
    basin_seq = rng.integers(0, n_basins, size=int(basin[-1]) + 1)
    which = basin_seq[basin]
    return (centers[which]
            + rng.normal(size=(n, d)) * scales).astype(np.float32)


# -- phase 1 -------------------------------------------------------------------

def phase_device():
    # the run uses one card: show torch only the first visible one
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = first
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if torch.cuda.device_count() != 1:
        fail(f"expected one visible card, got {torch.cuda.device_count()}")
    card = ["-i", first] if first.isdigit() else []
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"] + card,
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print("[device]", smi)
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return torch, smi


# -- phase 2 -------------------------------------------------------------------

def phase_build():
    from clustering_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path, _ = _build.build()
    _build.library()
    print(f"[build] {os.path.relpath(path)} in"
          f" {time.perf_counter() - t0:.3f}s")


# -- phase 3 -------------------------------------------------------------------

def timed(torch, fn, reps=3):
    """(result, mean ms) of ``fn`` over ``reps`` runs after one warm-up,
    with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def max_abs_err(got, want):
    """Largest |got - want| over the elements, 0.0 for none."""
    if got.numel() == 0:
        return 0.0
    return float((got.double() - want.double()).abs().max())


def hold(torch, name, what, kernel, plain, compare):
    """Time ``kernel`` and ``plain`` (the kernel's plain version) on the
    same inputs, compare their results with ``compare`` -> (mismatches,
    max abs err, text), print one line and fail on any mismatch. Returns
    the plain result."""
    got, ms = timed(torch, kernel)
    want, plain_ms = timed(torch, plain)
    bad, err, text = compare(got, want)
    print(f"[kernels] {name}: {what}, {text}, kernel {ms:.3f} ms, plain"
          f" {plain_ms:.3f} ms")
    if bad:
        fail(f"{name} disagrees with its plain version")
    return want


def exact(unit):
    def compare(got, want):
        bad = int((got != want).sum())
        return bad, max_abs_err(got, want), f"{bad} {unit} mismatches"
    return compare


def keys_equal(torch, n):
    """Compare two NN key buffers over the first ``n`` original ids: ids
    equal and distances bit-equal."""
    from clustering_tpu_torch.ops import kernels

    def compare(got, want):
        gd, gj = kernels.unpack_keys(got[:, :n])
        wd, wj = kernels.unpack_keys(want[:, :n])
        bad_j = int((gj != wj).sum())
        bad_d = int((gd.view(torch.int32) != wd.view(torch.int32)).sum())
        fin = torch.isfinite(gd) & torch.isfinite(wd)
        err = max_abs_err(gd[fin], wd[fin])
        return bad_j + bad_d, err, (
            f"{bad_j} id mismatches, {bad_d} distances not bit-equal (max"
            f" abs err {err})")
    return compare


def rows_equal(torch):
    """Compare two (nh_d, nh_j, hd_d, hd_j) row-position results: ids
    equal and distances bit-equal."""
    def compare(got, want):
        bad_j = sum(int((got[i] != want[i]).sum()) for i in (1, 3))
        bad_d = sum(int((got[i].view(torch.int32)
                         != want[i].view(torch.int32)).sum()) for i in (0, 2))
        err = 0.0
        for i in (0, 2):
            fin = torch.isfinite(got[i]) & torch.isfinite(want[i])
            err = max(err, max_abs_err(got[i][fin], want[i][fin]))
        return bad_j + bad_d, err, (
            f"{bad_j} id mismatches, {bad_d} distances not bit-equal (max"
            f" abs err {err})")
    return compare


def shuffled(ti, tj, seed=5):
    """A tile list in a random order (the kernels' results cannot depend
    on it)."""
    import torch
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(len(ti)),
                           device=ti.device)
    return ti[perm], tj[perm]


def kept_cells(words, nrb, ncb):
    """'kept/total cells' of a dense grid's skip words."""
    from clustering_tpu_torch.ops import kernels
    kept = len(kernels.kept_tiles(words, nrb, ncb)[0])
    return f"{kept}/{nrb * ncb} cells"


def phase_kernels(torch):
    from clustering_tpu_torch.ops import kernels, pruning
    from clustering_tpu_torch.ops.density import free_energies
    from clustering_tpu_torch.ops.engine import NN_BAND_BLOCKS, DensityEngine
    from clustering_tpu_torch.ops.neighbors import compute_sigma2
    from clustering_tpu_torch.ops.screening import ThresholdSeriesScreener
    dev = torch.device("cuda")
    coords = synthetic_fel(N_KERNELS, DIM, seed=0)
    eng = DensityEngine(coords, device=dev)
    rb, cb, n = eng.row_block, eng.col_block, eng.n

    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    # populations at the main path's radius: the upper-triangular plan,
    # then the full plane the symmetric path plans
    r2 = put(np.asarray([np.float32(RADIUS) ** 2], np.float32))
    name, ti, tj, rmask = eng.pops_plan([RADIUS], bidir=True)
    ct = eng.coords_t(name)
    args = (r2, n, put(ti), put(tj), put(rmask), rb, cb)
    want = hold(torch, "pops_bidir", f"{len(ti)} tiles",
                lambda: kernels.pops_bidir(ct, *args),
                lambda: kernels.pops_bidir_plain(ct, *args),
                exact("count"))
    name_s, ti_s, tj_s, rm_s = eng.pops_plan([RADIUS], bidir=False)
    ct_s = eng.coords_t(name_s)
    args = (ct_s, ct_s, r2, n, put(ti_s), put(tj_s), put(rm_s), rb, cb)
    hold(torch, "pops_sparse", f"{len(ti_s)} tiles",
         lambda: kernels.pops_sparse(*args),
         lambda: kernels.pops_sparse_plain(*args), exact("count"))
    # several radii at once (the CLI's -R; the 2^20 path counts one): the
    # counting kernels' multi-radius instances, with the plan's rmask cut
    # by a random one
    radii3 = [RADIUS / 2, RADIUS, 2 * RADIUS]
    r2_3 = put(np.asarray([np.float32(r) * np.float32(r) for r in radii3],
                          np.float32))
    name3, ti3, tj3, rm3 = eng.pops_plan(radii3, bidir=True)
    rm3 = rm3 & put(np.random.default_rng(3).integers(1, 8, size=len(rm3),
                                                      dtype=np.int32))
    ct3 = eng.coords_t(name3)
    args = (r2_3, n, put(ti3), put(tj3), put(rm3), rb, cb)
    hold(torch, "pops_bidir", f"3 radii, partial rmask, {len(ti3)} tiles",
         lambda: kernels.pops_bidir(ct3, *args),
         lambda: kernels.pops_bidir_plain(ct3, *args), exact("count"))
    name3, ti3, tj3, rm3 = eng.pops_plan(radii3, bidir=False)
    rm3 = rm3 & put(np.random.default_rng(4).integers(1, 8, size=len(rm3),
                                                      dtype=np.int32))
    ct3 = eng.coords_t(name3)
    args = (ct3, ct3, r2_3, n, put(ti3), put(tj3), put(rm3), rb, cb)
    hold(torch, "pops_sparse", f"3 radii, partial rmask, {len(ti3)} tiles",
         lambda: kernels.pops_sparse(*args),
         lambda: kernels.pops_sparse_plain(*args), exact("count"))

    # nearest neighbours: the band pass's tile lists in Morton order, the
    # upper-triangular closure and the band itself
    counts = want[0, :n].cpu().numpy() + 1  # the engine's self count
    order = eng._layout(name)
    pops = np.empty(n, np.int64)
    pops[order] = counts
    fe = free_energies(pops)
    fe_l = eng._fe_layout(fe, "morton")
    oid = eng.oid("morton")
    ct_m = eng.coords_t("morton")
    bti, btj = pruning.tile_list_device(eng.nn_band_mask(bidir=True)[1])

    def nn_run(fn, *lead):
        return fn(*lead, ct_m, fe_l, oid, n, bti, btj,
                  kernels.nn_keys_init(eng.n_pad, dev), rb, cb)

    want = hold(torch, "nn_bidir", f"{len(bti)} tiles",
                lambda: nn_run(kernels.nn_bidir),
                lambda: nn_run(kernels.nn_bidir_plain), keys_equal(torch, n))
    bti, btj = pruning.tile_list_device(eng.nn_band_mask(bidir=False)[1])
    rows = (ct_m, fe_l, oid)
    hold(torch, "nn_sparse", f"{len(bti)} tiles",
         lambda: nn_run(kernels.nn_sparse, *rows),
         lambda: nn_run(kernels.nn_sparse_plain, *rows),
         keys_equal(torch, n))
    bti, btj = shuffled(bti, btj)
    hold(torch, "nn_sparse", f"{len(bti)} tiles shuffled",
         lambda: nn_run(kernels.nn_sparse, *rows),
         lambda: nn_run(kernels.nn_sparse_plain, *rows),
         keys_equal(torch, n))
    # the symmetric route's phase-2 call: its rows start from the band
    # pass's keys, which the recorded buffer holds
    with bidir_switches(False), record_calls(["nn_sparse"]) as rec:
        eng.nearest_neighbors(fe)
    (p2, _), = rec["nn_sparse"][-1:]

    def nn_phase2(fn):
        return fn(*p2[:9], p2[9].clone(), *p2[10:])

    hold(torch, "nn_sparse", f"phase-2 list, {len(p2[7])} tiles, keys from"
         " the band pass", lambda: nn_phase2(kernels.nn_sparse),
         lambda: nn_phase2(kernels.nn_sparse_plain), keys_equal(torch, n))

    # the dense-grid kernels on the Morton layout: radius skip words for
    # the counts; band words, then the band's bound words, for NN
    padded = eng.coords_t("morton").T.cpu().numpy()
    nrb, ncb = eng.n_pad // rb, eng.n_pad // cb
    words = put(pruning.radius_skip_words(padded, rb, cb, r2.item())[0])
    hold(torch, "pops_tiles", kept_cells(words, nrb, ncb),
         lambda: kernels.pops_tiles(ct_m, r2, n, words, rb, cb),
         lambda: kernels.pops_tiles_cross_plain(ct_m, ct_m, r2, n, words, rb,
                                                cb),
         exact("count"))
    words = put(pruning.radius_skip_words(padded, rb, cb,
                                          r2_3.max().item())[0])
    hold(torch, "pops_tiles", "3 radii, " + kept_cells(words, nrb, ncb),
         lambda: kernels.pops_tiles(ct_m, r2_3, n, words, rb, cb),
         lambda: kernels.pops_tiles_cross_plain(ct_m, ct_m, r2_3, n, words,
                                                rb, cb),
         exact("count"))
    fe_r, oid_r = fe_l.reshape(1, -1), oid.reshape(1, -1)

    def nn_tiles_run(fn, words):
        return fn(ct_m, fe_r, ct_m, fe_r, oid_r, n, words, rb, cb)

    words = put(pruning.band_skip_words(nrb, ncb, rb, cb,
                                        NN_BAND_BLOCKS * cb)[0])
    band = hold(torch, "nn_tiles", "band, " + kept_cells(words, nrb, ncb),
                lambda: kernels.nn_tiles(ct_m, fe_r, oid_r, n, words, rb, cb),
                lambda: nn_tiles_run(kernels.nn_tiles_cross_plain, words),
                rows_equal(torch))
    ub = torch.maximum(band[0], band[2])[0]
    ub[n:] = 0.0  # pads need no neighbour
    row_ub = ub.reshape(nrb, rb).amax(dim=1).cpu().numpy()
    words = put(pruning.ub_skip_words(padded, rb, cb, row_ub)[0])
    hold(torch, "nn_tiles",
         "band bounds, " + kept_cells(words, nrb, ncb),
         lambda: nn_tiles_run(kernels.nn_tiles_cross, words),
         lambda: nn_tiles_run(kernels.nn_tiles_cross_plain, words),
         rows_equal(torch))

    # screening: the first sweep of the series' last threshold, over the
    # upper-triangular list and over the full list (every column block
    # dirty, then every third)
    wd, _ = kernels.unpack_keys(want[:, :n])
    nh_d = wd[0].cpu().numpy()
    nh_d = np.where(np.isfinite(nh_d), nh_d, 0.0)
    md2 = np.float32(4.0 * compute_sigma2(nh_d))
    series = ThresholdSeriesScreener(
        coords, fe, [np.float32(t) for t in THRESHOLDS], device=dev)
    seng = series.engine
    nb = int(series.n_below_per_band[-1])
    labels = torch.arange(seng.n_pad, dtype=torch.int32, device=dev)
    tiles = seng.tile_list(0, nb, md2, triangular=True)
    sti, stj = put(tiles[0]), put(tiles[1])
    dirty = torch.ones(len(tiles[0]), dtype=torch.int32, device=dev)
    largs = (seng.coords_t, labels, nb, md2, sti, stj, dirty, rb, cb)
    hold(torch, "label_min_bidir", f"{len(tiles[0])} tiles",
         lambda: kernels.label_min_bidir(*largs),
         lambda: kernels.label_min_bidir_plain(*largs),
         exact("label"))
    tiles = seng.tile_list(0, nb, md2, triangular=False)
    sti, stj = put(tiles[0]), put(tiles[1])
    ncb = seng.n_pad // cb
    for what, dirty in (
            ("all column blocks dirty",
             torch.ones(ncb, dtype=torch.int32, device=dev)),
            ("every third column block dirty",
             (torch.arange(ncb, device=dev) % 3 == 0).to(torch.int32))):
        largs = (seng.coords_t, seng.coords_t, labels, nb, md2, sti, stj, 0,
                 dirty, rb, cb)
        hold(torch, "label_min_sparse", f"{len(tiles[0])} tiles, {what}",
             lambda: kernels.label_min_sparse(*largs),
             lambda: kernels.label_min_sparse_plain(*largs),
             exact("proposal"))
    # the labels of a finished symmetric fixpoint (the step skip's path),
    # every column block dirty, on the list and on the list shuffled
    with bidir_switches(False):
        final = seng.run_device(labels, nb, md2)
    dirty = torch.ones(ncb, dtype=torch.int32, device=dev)
    for what, (lti, ltj) in (("", (sti, stj)),
                             (" shuffled", shuffled(sti, stj))):
        largs = (seng.coords_t, seng.coords_t, final, nb, md2, lti, ltj, 0,
                 dirty, rb, cb)
        hold(torch, "label_min_sparse",
             f"{len(tiles[0])} tiles{what}, labels of a finished fixpoint",
             lambda: kernels.label_min_sparse(*largs),
             lambda: kernels.label_min_sparse_plain(*largs),
             exact("proposal"))


# -- phases 4 and 5 ------------------------------------------------------------

def stage_walls(out):
    """{stage: seconds} of the density CLI's ``-v`` stage timer lines in
    ``out``."""
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"\[([a-z .0-9]+): ([0-9.]+)s\]", out)}


def substages(out):
    """{stage: its sub-stage text} of the ``-v`` lines that
    CLUSTERING_TPU_PROFILE_SUBSTAGES adds to ``out``."""
    return dict(re.findall(r"\[(\w+) substages: ([^\]]*)\]", out))


def run_cli(workdir, coords, device, extra=()):
    """Run the port's density CLI in ``workdir`` on ``device`` with the
    ``extra`` arguments, on ``coords`` (None: the ``coords.dat`` there);
    returns its stdout (also echoed)."""
    from clustering_tpu_torch import cli
    os.makedirs(workdir, exist_ok=True)
    if coords is not None:
        np.savetxt(os.path.join(workdir, "coords.dat"), coords, fmt="%.6f")
    cwd = os.getcwd()
    buf = io.StringIO()
    os.environ[cli.DEVICE_ENV] = device
    try:
        os.chdir(workdir)
        with contextlib.redirect_stdout(buf):
            rc = cli.main(ARGV + list(extra))
    finally:
        os.chdir(cwd)
    out = buf.getvalue()
    print(out, end="")
    if rc != 0:
        fail(f"density CLI on {device} exited {rc}")
    return out


def data_lines(path):
    with open(path) as fh:
        return [ln for ln in fh if ln.startswith("#@")
                or not ln.startswith("#")]


def read_nn(path):
    rows = [ln.split() for ln in data_lines(path) if not ln.startswith("#")]
    return np.asarray(rows, dtype=np.float64)


def phase_slice(tmp):
    coords = synthetic_fel(N_SLICE, DIM, seed=1)
    walls = {}
    for device, extra in (("cuda", ["--check"]), ("cpu", [])):
        t0 = time.perf_counter()
        out = run_cli(os.path.join(tmp, device), coords, device, extra)
        walls[device] = time.perf_counter() - t0
        if extra:
            checks = re.findall(r"\[check\] (\w+): (\d+)/(\d+)", out)
            if sorted(kind for kind, _, _ in checks) != ["nn", "pops"]:
                fail(f"--check printed {checks}, not one pops and one nn"
                     " line")
            print("[slice] --check on cuda: " + ", ".join(
                f"{kind} {bad}/{total} entries differ"
                for kind, bad, total in checks))
    a, b = os.path.join(tmp, "cuda"), os.path.join(tmp, "cpu")
    names = ["pop", "fe"] + [f"clust.{t}" for t in THRESHOLDS]
    for name in names:
        if data_lines(os.path.join(a, name)) != data_lines(
                os.path.join(b, name)):
            fail(f"{name} differs between cuda and cpu")
    na, nb = read_nn(os.path.join(a, "nn")), read_nn(os.path.join(b, "nn"))
    if not np.array_equal(na[:, [0, 2]], nb[:, [0, 2]]):
        fail("nn ids differ between cuda and cpu")
    d_a, d_b = na[:, [1, 3]], nb[:, [1, 3]]
    # one unit of the last of the 6 printed significant digits
    unit = 10.0 ** (np.floor(np.log10(np.maximum(np.abs(d_b), 1e-30))) - 5)
    diff = np.abs(d_a - d_b)
    n_off = int((diff > 0).sum())
    if (diff > unit * 1.0000001).any():
        fail("nn distances differ beyond the last printed digit")
    print(f"[slice] N={N_SLICE}: {', '.join(names)} identical, nn ids"
          f" identical, {n_off} nn distances differ in the last digit;"
          f" cuda {walls['cuda']:.3f}s, cpu {walls['cpu']:.3f}s")


def check_outputs(where, n, pops, fe, ids, dists, clust):
    """The density outputs' invariants: ``n`` populations >= 1, finite
    free energies and distances, neighbour ids in range, every lower-fe
    neighbour of lower free energy, absent ones (0, 0.0), at least one
    state in ``clust`` (the last threshold's). ``ids`` and ``dists`` are
    (N, 2): nearest, then nearest lower-fe neighbour."""
    if pops.shape != (n,) or pops.min() < 1:
        fail("populations must be >= 1 for every frame")
    if not np.isfinite(fe).all() or not np.isfinite(dists).all():
        fail("non-finite output")
    if ids.min() < 0 or ids.max() >= n:
        fail("neighbour ids out of range")
    has_hd = dists[:, 1] > 0
    if not (fe[ids[has_hd, 1]] < fe[has_hd]).all():
        fail("a higher-density neighbour without lower free energy")
    absent = ~has_hd
    if (ids[absent, 1] != 0).any():
        fail("absent higher-density neighbours must be (0, 0.0)")
    n_states = int(clust.max())
    if n_states < 1:
        fail(f"no state at threshold {THRESHOLDS[-1]}")
    print(f"[{where}] {n_states} states at {THRESHOLDS[-1]}; pops in"
          f" [{pops.min()}, {pops.max()}]; {int(absent.sum())} frames"
          " without a lower-fe neighbour")


def phase_main(torch, tmp):
    from clustering_tpu_torch.ops import kernels
    from clustering_tpu_torch.ops.density import free_energies
    coords = synthetic_fel(N_MAIN, DIM, seed=0)
    kernels.reset_launches()
    t0 = time.perf_counter()
    os.environ[SUBSTAGES_ENV] = "1"
    try:
        out = run_cli(os.path.join(tmp, "main"), coords, "cuda")
    finally:
        del os.environ[SUBSTAGES_ENV]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    walls = stage_walls(out)
    for stage in ["populations", "nearest neighbors"] + [
            f"screening {t}" for t in THRESHOLDS]:
        if stage not in walls:
            fail(f"no wall for stage {stage!r}")
    print(f"[main] N={N_MAIN} D={DIM}: wall {wall:.3f}s, stages "
          + json.dumps({k: walls[k] for k in walls}))
    print(f"[main] launches {json.dumps(launches)}")
    # the NN stage took the band pass that populations started, and the
    # screener was built while it ran
    nn_line = re.search(r"\[nn: (\d+) tiles computed = [0-9.]+% of N\^2"
                        r" incl\. padding, ([a-z-]+) phase 2(, band"
                        r" prefetched)?\]", out)
    built = re.search(r"\[screener built during nearest neighbors in"
                      r" ([0-9.]+)s\]", out)
    subs = substages(out)
    if nn_line is None or not nn_line.group(3):
        fail("the CLI's NN stage did not take the band prefetch")
    if built is None:
        fail("the CLI did not build the screener during the NN stage")
    print(f"[main] NN {nn_line.group(2)} phase 2, {nn_line.group(1)} tiles"
          f" (band and phase 2), band prefetched; screener built during NN"
          f" in {built.group(1)}s; substages {json.dumps(subs)}")
    for name in BIDIR_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the main path")
    d = os.path.join(tmp, "main")
    pops = np.loadtxt(os.path.join(d, "pop"), dtype=np.int64)
    nn = read_nn(os.path.join(d, "nn"))
    clust = np.loadtxt(os.path.join(d, "clust.2.00"), dtype=np.int64)
    # the fe file is printed rounded; its exact fp32 values follow from
    # the integer populations
    fe = free_energies(pops)
    fe_file = np.loadtxt(os.path.join(d, "fe"), dtype=np.float64)
    if not np.allclose(fe_file, fe, rtol=1e-5, atol=1e-6):
        fail("fe file does not match the populations")
    check_outputs("main", N_MAIN, pops, fe, nn[:, [0, 2]].astype(np.int64),
                  nn[:, [1, 3]], clust)
    return launches


# -- phase 6 -------------------------------------------------------------------

def run_engines(torch, coords, stats=None, keep=None, mesh=None,
                tier_qs="auto", mem=None):
    """populations -> free energies -> nearest neighbours -> screening
    series through the port's engines on the card, as the density CLI runs
    them: without a mesh, populations starts the NN band pass and the
    screener is built on a worker thread while NN runs (its lower-fe edges
    attached after), over the ranks of ``mesh`` one after the other. NN
    takes ``tier_qs``. Returns (pops, nn, clusterings, stage walls, stage
    routes); fills ``stats``, if given, with each stage's ``last_stats``,
    and ``keep``, if given, with the density engine, the screener, the
    linking distance, the free energies and the screener's build seconds
    without a mesh (``engine``, ``series``, ``md2``, ``fe``,
    ``screener_build``), and ``mem``, if given, with each stage's peak of
    device memory (the peak statistics reset as the stage starts)."""
    from concurrent.futures import ThreadPoolExecutor

    from clustering_tpu_torch.ops.density import free_energies
    from clustering_tpu_torch.ops.engine import DensityEngine
    from clustering_tpu_torch.ops.neighbors import compute_sigma2
    from clustering_tpu_torch.ops.screening import ThresholdSeriesScreener
    walls, modes = {}, {}

    def stage(name, fn, *args, sync=True):
        if mem is not None:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*args)
        if sync:
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        if mem is not None:
            mem[name] = torch.cuda.max_memory_allocated()
        return out

    def record(name, last):
        modes[name] = last.get("route", last["mode"])
        if stats is not None:
            stats[name] = dict(last)

    def build(fe, thresholds):
        t0 = time.perf_counter()
        series = ThresholdSeriesScreener(coords, fe, thresholds,
                                         device="cuda")
        return series, time.perf_counter() - t0

    eng = DensityEngine(coords, device="cuda", mesh=mesh)
    # its counts are on the host already; a device sync here would wait
    # for the band pass it started
    pops = stage("populations", lambda: eng.populations(
        [RADIUS], nn_band_radius=RADIUS)[RADIUS], sync=False)
    record("populations", eng.last_stats["populations"])
    fe = free_energies(pops)
    thresholds = [np.float32(t) for t in THRESHOLDS]
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = None if mesh is not None else pool.submit(build, fe,
                                                        thresholds)
        nn = stage("nearest neighbors",
                   lambda: eng.nearest_neighbors(fe, tier_qs=tier_qs))
        record("nearest neighbors", eng.last_stats["nn"])
        md2 = np.float32(4.0 * compute_sigma2(nn[1]))

        def setup():
            if fut is None:
                return ThresholdSeriesScreener(
                    coords, fe, thresholds, device="cuda",
                    hd_neighbors=(nn[2], nn[3]), mesh=mesh)
            series, t_build = fut.result()
            series.set_hd_neighbors((nn[2], nn[3]))
            if keep is not None:
                keep["screener_build"] = t_build
            return series

        series = stage("screening setup", setup)
    clust, prev = [], None
    for k, t in enumerate(THRESHOLDS):
        prev = stage(f"screening {t}", series.step, prev, k, md2)
        clust.append(prev)
        record(f"screening {t}", series.engine.last_stats)
    if keep is not None:
        keep.update(engine=eng, series=series, md2=md2, fe=fe)
    return pops, nn, clust, walls, modes


@contextlib.contextmanager
def bidir_switches(on):
    """The engines' three bidirectional switches (``POPS_BIDIR``,
    ``NN_BIDIR``, ``BIDIR``) set to ``on`` while the block runs, restored
    after it."""
    from clustering_tpu_torch.ops.engine import DensityEngine
    from clustering_tpu_torch.ops.screening import ScreeningEngine
    saved = (DensityEngine.POPS_BIDIR, DensityEngine.NN_BIDIR,
             ScreeningEngine.BIDIR)
    DensityEngine.POPS_BIDIR = DensityEngine.NN_BIDIR = on
    ScreeningEngine.BIDIR = on
    try:
        yield
    finally:
        (DensityEngine.POPS_BIDIR, DensityEngine.NN_BIDIR,
         ScreeningEngine.BIDIR) = saved


def same_results(run_a, run_b, what):
    """Fail unless two ``run_engines`` results have identical populations,
    nn ids, nn distances (bit for bit) and clusterings; ``what`` names the
    two runs."""
    pops_a, nn_a, clust_a = run_a[:3]
    pops_b, nn_b, clust_b = run_b[:3]
    if not np.array_equal(pops_a, pops_b):
        fail(f"populations differ between {what}")
    for i in (0, 2):
        if not np.array_equal(nn_a[i], nn_b[i]):
            fail(f"nn ids differ between {what}")
    for i in (1, 3):
        if not np.array_equal(np.asarray(nn_a[i], np.float32).view(np.int32),
                              np.asarray(nn_b[i], np.float32).view(np.int32)):
            fail(f"nn distances differ between {what}")
    for t, a, b in zip(THRESHOLDS, clust_a, clust_b):
        if not np.array_equal(a, b):
            fail(f"clustering at {t} differs between {what}")


def tier_check(torch, where, keep, nn, stats, walls):
    """NN once more on a ``run_engines`` run's engine, block-bound
    (``tier_qs=None``): ids and distances must equal the run's ``nn`` bit
    for bit. Prints both runs' phase-2 mode and tiles, NN wall and
    sub-stage times; stores the block-bound run's stats in
    ``stats["nn block-bound"]``."""
    eng = keep["engine"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nn_bb = eng.nearest_neighbors(keep["fe"], tier_qs=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats["nn block-bound"] = dict(eng.last_stats["nn"])
    for i in (0, 2):
        if not np.array_equal(nn[i], nn_bb[i]):
            fail(f"{where}: nn ids differ between the run and block-bound")
    for i in (1, 3):
        if not np.array_equal(nn[i].view(np.int32), nn_bb[i].view(np.int32)):
            fail(f"{where}: nn distances differ between the run and"
                 " block-bound")

    def row(st, wall):
        keys = ("mode", "route", "band_prefetched", "order", "band_tiles",
                "phase2_tiles", "t_band", "t_plan", "t_sweep")
        return dict({k: st[k] for k in keys if k in st}, wall=wall)

    run = row(stats["nearest neighbors"], walls["nearest neighbors"])
    print(f"[tiers] {where}: the run's NN {json.dumps(run)}")
    print(f"[tiers] {where}: block-bound NN"
          f" {json.dumps(row(stats['nn block-bound'], wall))}; ids and"
          " distances bit-identical")


def phase_symmetric(torch, calls):
    """Phase 6; ``calls`` is the record of the row-side kernels' calls,
    from which the block-bound check's own calls are taken out."""
    from clustering_tpu_torch.ops import kernels
    from clustering_tpu_torch.ops.engine import DensityEngine
    coords = synthetic_fel(N_MAIN, DIM, seed=0)
    runs = {}
    for mode, on in (("bidir", True), ("symmetric", False)):
        keep, stats = {}, {}
        # the row-side route tiers its phase 2 whatever the auto rule says,
        # so that nn_sparse sweeps a tiered list
        qs = "auto" if on else DensityEngine.TIER_QS_DEFAULT
        with bidir_switches(on):
            kernels.reset_launches()
            out = run_engines(torch, coords, stats, keep, tier_qs=qs)
            runs[mode] = out + (dict(kernels.LAUNCHES), stats)
            n_calls = len(calls["nn_sparse"])
            tier_check(torch, f"N={N_MAIN} {mode}", keep, out[1], stats,
                       out[3])
            del calls["nn_sparse"][n_calls:]
        print(f"[symmetric] {mode} run: screener built during NN in"
              f" {keep['screener_build']:.3f}s")
        if on:
            plan_check(torch, f"N={N_MAIN}", keep["engine"], keep["series"],
                       keep["md2"], out[1])
            warm_check(torch, keep, out)
        del keep
    for mode, (_, _, _, walls, modes, launches, stats) in runs.items():
        print(f"[symmetric] {mode} run N={N_MAIN} D={DIM}: stages "
              + json.dumps(walls))
        print(f"[symmetric] {mode} run: modes {json.dumps(modes)}, launches"
              f" {json.dumps(launches)}")
        if set(modes.values()) != {mode}:
            fail(f"the {mode} run took another route: {modes}")
        plans = {name: st["plan"] for name, st in stats.items()}
        if set(plans.values()) != {"device"}:
            fail(f"a stage of the {mode} run was not planned on the device:"
                 f" {plans}")
        on, off = ((BIDIR_KERNELS, SPARSE_KERNELS) if mode == "bidir"
                   else (SPARSE_KERNELS, BIDIR_KERNELS))
        for name in on:
            if launches[name] <= 0:
                fail(f"kernel {name} was not launched by the {mode} run")
        for name in off:
            if launches[name] != 0:
                fail(f"kernel {name} was launched by the {mode} run")
    same_results(runs["bidir"], runs["symmetric"],
                 "the bidir and symmetric paths")
    if runs["symmetric"][6]["nearest neighbors"]["mode"] != "tiered":
        fail("the symmetric run's NN did not sweep a tiered phase 2")
    clust_s = runs["symmetric"][2]
    print(f"[symmetric] N={N_MAIN}: populations, nn ids, nn distances (bit"
          f" for bit) and {len(THRESHOLDS)} clusterings identical;"
          f" {int(clust_s[-1].max())} states at {THRESHOLDS[-1]}")
    return runs


def cli_files_check(torch, tmp):
    """Phase 5's files (the CLI: band prefetch, the auto rule's phase 2,
    the screener built during NN) against the pipeline before them, on
    the coordinates the CLI read: populations, NN block-bound without a
    prefetch, the screener built after NN. The pop, nn and clust.* data
    lines the port's writers give for its arrays must equal phase 5's,
    byte for byte."""
    from clustering_tpu_torch.ops.density import free_energies
    from clustering_tpu_torch.ops.engine import DensityEngine
    from clustering_tpu_torch.ops.neighbors import compute_sigma2
    from clustering_tpu_torch.ops.screening import ThresholdSeriesScreener
    from clustering_tpu_torch.utils import io as tio
    d, ref = os.path.join(tmp, "main"), os.path.join(tmp, "before")
    os.makedirs(ref)
    coords = tio.read_coords(os.path.join(d, "coords.dat"))
    eng = DensityEngine(coords, device="cuda")
    pops = eng.populations([RADIUS])[RADIUS]
    fe = free_energies(pops)
    nn = eng.nearest_neighbors(fe, tier_qs=None)
    st = eng.last_stats["nn"]
    if st["band_prefetched"] or st["mode"] != "block-bound":
        fail("the pipeline before this change ran another NN route")
    md2 = np.float32(4.0 * compute_sigma2(nn[1]))
    series = ThresholdSeriesScreener(
        coords, fe, [np.float32(t) for t in THRESHOLDS], device="cuda",
        hd_neighbors=(nn[2], nn[3]))
    tio.write_pops(os.path.join(ref, "pop"), pops, "", {})
    tio.write_neighborhood(os.path.join(ref, "nn"), *nn)
    prev = None
    for k, t in enumerate(THRESHOLDS):
        prev = series.step(prev, k, md2)
        tio.write_clustered_trajectory(os.path.join(ref, f"clust.{t}"),
                                       prev, "", {})
    names = ["pop", "nn"] + [f"clust.{t}" for t in THRESHOLDS]
    for name in names:
        lines = []
        for where in (d, ref):
            with open(os.path.join(where, name)) as fh:
                lines.append([ln for ln in fh if not ln.startswith("#")])
        if lines[0] != lines[1]:
            fail(f"phase 5's {name} differs from the pipeline before it")
    print(f"[main] {', '.join(names)}: data lines byte-identical to"
          " populations, block-bound NN without prefetch and the screener"
          " built after NN on the same coordinates")
    return coords, fe, nn


# -- phase 7 -------------------------------------------------------------------

def phase_skip_words(torch, want_pops, want_nn):
    """The dense skip-word route at 2^20, composed as the JAX library's
    pops_tiles / nn_tiles docstrings leave it to callers; must equal the
    bidirectional engine run (``want_pops``, ``want_nn``). Returns (launch
    counts, stage walls)."""
    from clustering_tpu_torch.ops import kernels, pruning
    from clustering_tpu_torch.ops.density import free_energies
    from clustering_tpu_torch.ops.engine import NN_BAND_BLOCKS
    coords = synthetic_fel(N_MAIN, DIM, seed=0)
    rb, cb = kernels.DEFAULT_ROW_BLOCK, kernels.DEFAULT_COL_BLOCK
    n = N_MAIN
    block = int(np.lcm(rb, cb))
    n_pad = -(-n // block) * block
    nrb, ncb = n_pad // rb, n_pad // cb
    walls, cells = {}, {}

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device="cuda")

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    def layout():
        order = pruning.morton_order(coords)
        padded = np.full((n_pad, DIM), np.float32(3e38), np.float32)
        padded[:n] = coords[order]
        return order, padded, put(padded.T)

    def pass_words(name, words):
        w = put(words)
        cells[name] = len(kernels.kept_tiles(w, nrb, ncb)[0])
        return w

    kernels.reset_launches()
    order, padded, ct = stage("layout", layout)
    r2 = np.float32(RADIUS) * np.float32(RADIUS)

    def populations():
        words = pruning.radius_skip_words(padded, rb, cb, r2, strict=True)[0]
        counts = kernels.pops_tiles(ct, put(np.asarray([r2])), n,
                                    pass_words("populations", words), rb, cb)
        pops = np.empty(n, np.int64)
        pops[order] = counts[0, :n].cpu().numpy()
        return pops

    pops = stage("populations", populations)
    fe = free_energies(pops)
    fe_l = np.full((1, n_pad), np.inf, np.float32)
    fe_l[0, :n] = fe[order]
    oid = np.full((1, n_pad), np.iinfo(np.int32).max, np.int32)
    oid[0, :n] = order
    fe_l, oid = put(fe_l), put(oid)

    def nn_pass(name, words):
        return kernels.nn_tiles(ct, fe_l, oid, n, pass_words(name, words),
                                rb, cb)

    band = stage("nn band", lambda: nn_pass("nn band", pruning.band_skip_words(
        nrb, ncb, rb, cb, NN_BAND_BLOCKS * cb)[0]))

    def phase2():
        # the band's distances bound each frame's true ones (+inf where it
        # held no lower-fe neighbour); tiles farther than the row block's
        # bound cannot hold a winner
        ub = torch.maximum(band[0], band[2])[0]
        ub[n:] = 0.0
        row_ub = ub.reshape(nrb, rb).amax(dim=1).cpu().numpy()
        out = nn_pass("nn phase 2",
                      pruning.ub_skip_words(padded, rb, cb, row_ub)[0])
        nn = []
        for d2, j in ((out[0], out[1]), (out[2], out[3])):
            d2, j = d2[0, :n].cpu().numpy(), j[0, :n].cpu().numpy()
            absent = ~(d2 < np.inf)
            ids = np.empty(n, np.int64)
            ids[order] = np.where(absent, 0, j)
            dist = np.empty(n, np.float32)
            dist[order] = np.where(absent, np.float32(0.0), d2)
            nn += [ids, dist]
        return nn

    nn = stage("nn phase 2", phase2)
    launches = dict(kernels.LAUNCHES)
    print(f"[skip words] N={n} D={DIM}: stages " + json.dumps(walls))
    print("[skip words] kept cells " + json.dumps(
        {k: f"{v}/{nrb * ncb}" for k, v in cells.items()})
        + f", launches {json.dumps(launches)}")
    if launches["pops_tiles"] < 1 or launches["nn_tiles"] < 2:
        fail("the skip-word route did not launch pops_tiles once and"
             " nn_tiles twice")
    if not np.array_equal(pops, want_pops):
        fail("skip-word populations differ from the bidirectional run")
    for i in (0, 2):
        if not np.array_equal(nn[i], want_nn[i]):
            fail("skip-word nn ids differ from the bidirectional run")
    for i in (1, 3):
        if not np.array_equal(
                nn[i].view(np.int32),
                np.asarray(want_nn[i], np.float32).view(np.int32)):
            fail("skip-word nn distances differ from the bidirectional run")
    print(f"[skip words] N={n}: populations, nn ids and nn distances (bit"
          " for bit) identical to the bidirectional run")
    return launches, walls


# -- phase 8 -------------------------------------------------------------------

# the wrapper that launches each kernel (the dense-grid kernels launch in
# their cross forms), and the argument a wrapper updates in place
WRAPPERS = {name: name for name in KERNELS}
WRAPPERS.update(pops_tiles="pops_tiles_cross", nn_tiles="nn_tiles_cross")
IN_PLACE = {"nn_bidir": 6, "nn_sparse": 9}
# FP32 peak outside the tensor cores and HBM3 rate of an H100 SXM at
# 700 W (the data sheet's dense figures)
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


@contextlib.contextmanager
def record_calls(names):
    """Record every call of the named kernels' wrappers while the block
    runs: a copy of each tensor argument, taken before the call, so that
    a replay sees the inputs the path gave the kernel. Yields
    {name: [(args, kwargs), ...]}."""
    import torch
    from clustering_tpu_torch.ops import kernels
    calls = {name: [] for name in names}
    saved = {}

    def copy(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    for name in names:
        attr = WRAPPERS[name]
        saved[attr] = fn = getattr(kernels, attr)

        def rec(*args, _fn=fn, _name=name, **kw):
            calls[_name].append((tuple(copy(a) for a in args),
                                 {k: copy(v) for k, v in kw.items()}))
            return _fn(*args, **kw)
        setattr(kernels, attr, rec)
    try:
        yield calls
    finally:
        for attr, fn in saved.items():
            setattr(kernels, attr, fn)


def replay(torch, name, fn, calls, per_call=None):
    """Run ``fn`` on every recorded call of kernel ``name`` (in-place
    arguments fresh from the record); returns (outputs, device ms summed
    over the calls), and appends each call's ms to ``per_call`` if given.
    Each call is timed with CUDA events behind a short device sleep, so
    the host's enqueue time stays out of the window."""
    outs, ms = [], 0.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for args, kw in calls:
        args = list(args)
        if name in IN_PLACE:
            args[IN_PLACE[name]] = args[IN_PLACE[name]].clone()
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        start.record()
        out = fn(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        ms += start.elapsed_time(end)
        if per_call is not None:
            per_call.append(start.elapsed_time(end))
        outs.append(out)
    return outs, ms


def _tensors(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def compare_outputs(torch, got, want):
    """(mismatching elements, max abs err over finite floats) of two lists
    of call outputs; floats compare bit for bit."""
    bad, err = 0, 0.0
    for g_call, w_call in zip(got, want):
        for g, w in zip(_tensors(g_call), _tensors(w_call)):
            if g.dtype.is_floating_point:
                bad += int((g.view(torch.int32) != w.view(torch.int32)).sum())
                fin = torch.isfinite(g) & torch.isfinite(w)
                err = max(err, max_abs_err(g[fin], w[fin]))
            else:
                bad += int((g != w).sum())
                err = max(err, max_abs_err(g, w))
    return bad, err


def evaluated_tiles(name, args):
    """The tiles or grid cells one call sweeps (label-min: only the dirty
    ones): an int for the dense grids, else a 0-d device tensor, taken
    without a host sync."""
    from clustering_tpu_torch.ops import kernels
    rb, cb = args[-2], args[-1]
    if name in ("pops_tiles", "nn_tiles"):
        words = args[4] if name == "pops_tiles" else args[6]
        cols_t = args[2] if name == "nn_tiles" else args[1]
        nrb, ncb = args[0].shape[1] // rb, cols_t.shape[1] // cb
        return len(kernels.kept_tiles(words, nrb, ncb)[0])
    if name in ("pops_bidir", "pops_sparse"):
        tj, rmask = args[-4], args[-3]
        return ((tj >= 0) & (rmask != 0)).sum()
    if name in ("nn_bidir", "nn_sparse"):
        return (args[-4] >= 0).sum()
    if name == "label_min_bidir":
        return (args[-3] != 0).sum()
    # label_min_sparse: ti, tj, row_block_offset, dirty
    tj, dirty = args[-5], args[-3]
    return ((tj >= 0) & (dirty[tj.clamp_min(0).long()] != 0)).sum()


def evaluated_pairs(name, args):
    """Pairs one recorded call evaluates: :func:`evaluated_tiles` x
    row_block x col_block."""
    return int(evaluated_tiles(name, args)) * args[-2] * args[-1]


def moved_bytes(args, outs):
    """Bytes a call must move: each distinct input tensor read once, each
    output written once."""
    import torch
    seen, total = set(), 0
    for a in args:
        if isinstance(a, torch.Tensor) and a.data_ptr() not in seen:
            seen.add(a.data_ptr())
            total += a.numel() * a.element_size()
    return total + sum(t.numel() * t.element_size() for t in _tensors(outs))


def phase_main_path_kernels(torch, calls, launches, smi):
    """Each kernel on the calls its 2^20 path made (bidirectional: phase 5;
    row-side: phase 6's symmetric run; dense-grid: phase 7), replayed:
    kernel time, its plain version on the same inputs (exact), evaluated
    pairs and the bound. Returns the kernels' JSON records."""
    from clustering_tpu_torch.ops import kernels
    records = []
    print(f"[path kernels] {smi}, N={N_MAIN} D={DIM}; bound = max(3 D flops"
          f" per pair / {PEAK_FLOPS / 1e12:.0f} TFLOP/s, bytes /"
          f" {PEAK_BYTES / 1e12:.2f} TB/s)")
    for name in KERNELS:
        rec = calls[name]
        fn = getattr(kernels, WRAPPERS[name])
        plain = getattr(kernels, WRAPPERS[name] + "_plain")
        replay(torch, name, fn, rec)  # warm-up
        got, ms = replay(torch, name, fn, rec)
        want, plain_ms = replay(torch, name, plain, rec)
        bad, err = compare_outputs(torch, got, want)
        if bad:
            fail(f"{name} disagrees with its plain version on its path's"
                 f" calls ({bad} elements)")
        pairs = sum(evaluated_pairs(name, args) for args, _ in rec)
        n_dim = rec[0][0][0].shape[0]
        t_ops = pairs * 3 * n_dim / PEAK_FLOPS * 1e3
        t_bytes = sum(moved_bytes(args, out) for (args, _), out
                      in zip(rec, got)) / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        per_call = ""
        if name in ("nn_bidir", "nn_sparse"):
            # the band pass, then phase 2 (tiered or block-bound)
            per_call = " tiles " + "/".join(str(len(args[-4]))
                                            for args, _ in rec) + ","
        print(f"[path kernels] {name}: {launches[name]} launches"
              f" ({len(rec)} calls),{per_call} {pairs} pairs,"
              f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound"
              f" {bound:.3f} ms ({by}), share {bound / ms:.3f}; 0"
              " mismatches")
        records.append({
            "name": name, "route": "cuda",
            "source": f"clustering_tpu_torch/csrc/{name}.cu",
            "replaces": KERNELS[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "pairs": pairs})
        del got, want
    return records


# -- plan check (phases 6 and 9) ----------------------------------------------

def plan_check(torch, where, engine, series, md2, nn):
    """After an engine run, each device planner of the bidirectional stages
    against the numpy planners on the same masks: the populations list and
    rmask, the NN band's closure, a phase-2 closure (each frame's bound:
    the larger of its two neighbour distances in ``nn``, +inf without a
    lower-fe neighbour) and every series step's screening list. The lists
    must be identical; prints each planner's seconds, device then host
    (the host side includes the download of its mask)."""
    from clustering_tpu_torch.ops import pruning
    from clustering_tpu_torch.ops.engine import NN_BAND_BLOCKS, NN_BAND_ORDER
    from clustering_tpu_torch.ops.screening import screen_active
    eng = engine
    rb, cb = eng.row_block, eng.col_block
    nrb, ncb = eng.n_pad // rb, eng.n_pad // cb
    secs, tiles = {}, {}

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def compare(stage, device, host):
        got, t_dev = clock(device)
        want, t_host = clock(host)
        got = None if got is None else [a.cpu().numpy() for a in got]
        if (got is None) != (want is None) or not all(
                np.array_equal(a, b) for a, b in zip(got or (), want or ())):
            fail(f"{where}: the device plan of {stage} differs from the"
                 " numpy planners'")
        secs[stage] = [t_dev, t_host]
        tiles[stage] = 0 if want is None else len(want[0])

    r2 = np.float32(RADIUS) * np.float32(RADIUS)
    name = eng._best_sort(r2)

    def host_pops():
        planes = pruning.threshold_planes(eng.d2b(name), [r2, r2])
        ti, tj = pruning.tile_list(
            planes[0] & pruning.upper_mask(nrb, ncb, rb, cb))
        return ti, tj, planes[1][ti, tj].astype(np.int32)

    compare("populations", lambda: eng.pops_plan([RADIUS])[1:], host_pops)
    compare("nn band",
            lambda: pruning.tile_list_device(eng.nn_band_mask()[1]),
            lambda: pruning.tile_list(pruning.bidir_closure(
                pruning.band_mask(nrb, ncb, rb, cb, NN_BAND_BLOCKS * cb),
                rb, cb)))
    order = eng.last_stats["nn"]["order"]
    ub_oid = torch.as_tensor(np.maximum(
        nn[1], np.where(nn[3] > 0, nn[3], np.inf)).astype(np.float32),
        device="cuda")
    oid = eng.oid(order).long()
    ub = torch.full((eng.n_pad,), float("inf"), device="cuda")
    ub[:eng.n] = ub_oid[oid[:eng.n]]
    act = eng.d2b(order) <= ub.reshape(nrb, rb).amax(dim=1)[:, None]
    if order == NN_BAND_ORDER:
        act &= ~eng.nn_band_mask()[0]
    compare("nn phase 2",
            lambda: pruning.tile_list_device(
                pruning.bidir_closure_device(act, rb, cb)),
            lambda: pruning.tile_list(
                pruning.bidir_closure(act.cpu().numpy(), rb, cb)))
    del act
    seng, row_lo = series.engine, 0
    below = seng._below_plane(md2)
    for t, nb in zip(THRESHOLDS, series.n_below_per_band):
        nb = int(nb)
        compare(f"screening {t}",
                lambda: seng.tile_list(row_lo, nb, md2),
                lambda: pruning.tile_list(screen_active(
                    below.cpu().numpy(), nb, row_lo, seng.row_block,
                    seng.col_block, True)))
        row_lo = nb
    print(f"[plan check] {where}: device / host planner seconds"
          f" {json.dumps(secs)}")
    print(f"[plan check] {where}: tiles {json.dumps(tiles)}, identical"
          " lists under both planners")
    return secs


# -- phase 9 -------------------------------------------------------------------

N_BIG = 1 << 24
N_SAMPLE = 256
SAMPLE_COLS = 1 << 18


def plan_report(tag, walls, stats):
    """Print one engine run's stage walls and, per stage, its planner,
    t_plan and (populations) t_best_sort; returns the stages' planners and
    tile counts."""
    stages = {name: {k: st[k] for k in ("plan", "t_plan", "t_best_sort")
                     if k in st} for name, st in stats.items()}
    print(f"[big N] {tag}: stages {json.dumps(walls)}")
    print(f"[big N] {tag}: plans {json.dumps(stages)}")
    return ({name: st["plan"] for name, st in stats.items()},
            stage_tiles(stats))


def stage_tiles(stats, share=False):
    """Tiles per stage of one ``run_engines`` run's ``stats``: each list's
    length, or (``share``) this rank's share of it on a mesh."""
    nn = stats["nearest neighbors"]
    if share:
        tiles = {"populations": stats["populations"]["per_device_tiles"],
                 "nn band": nn["per_device_tiles"]["band"],
                 "nn phase 2": nn["per_device_tiles"]["phase2"]}
    else:
        tiles = {"populations": stats["populations"]["computed_tiles"],
                 "nn band": nn["band_tiles"],
                 "nn phase 2": nn["phase2_tiles"]}
    for t in THRESHOLDS:
        st = stats[f"screening {t}"]
        tiles[f"screening {t}"] = st[
            "per_device_tiles" if share else "tiles_per_sweep"]
    return tiles


def sampled_check(torch, coords, pops, fe, nn, clust, md2, where="big N"):
    """N_SAMPLE frames drawn with a seeded generator, by a chunked sweep
    over all frames with the kernels' arithmetic (``pairwise.sq_dists``):
    their populations, nearest neighbour and nearest lower-fe neighbour
    (ties to the smaller id) must equal the engine's exactly, and at the
    last threshold each one's label must equal that of every admissible
    neighbour (both at or below the threshold, d2 < md2). Frames are
    labelled exactly when at or below the threshold."""
    from clustering_tpu_torch.ops.kernels import KEY_NONE, unpack_keys
    from clustering_tpu_torch.ops.pairwise import sq_dists
    n = len(coords)
    pick = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    pick = pick[:N_SAMPLE].sort().values
    x = torch.as_tensor(coords, device="cuda")
    fe_t = torch.as_tensor(fe, device="cuda")
    lab = torch.as_tensor(clust, device="cuda")
    below = fe_t <= float(np.float32(THRESHOLDS[-1]))
    if not torch.equal(lab > 0, below):
        fail("the last clustering labels other frames than those at or"
             " below its threshold")
    rows = pick.cuda()
    r2 = float(np.float32(RADIUS) * np.float32(RADIUS))
    count = torch.zeros(N_SAMPLE, dtype=torch.int64, device="cuda")
    keys = torch.full((2, N_SAMPLE), KEY_NONE, dtype=torch.int64,
                      device="cuda")
    n_adj = torch.zeros((), dtype=torch.int64, device="cuda")
    bad_lab = torch.zeros((), dtype=torch.int64, device="cuda")
    for lo in range(0, n, SAMPLE_COLS):
        cols = torch.arange(lo, min(lo + SAMPLE_COLS, n), device="cuda")
        d2 = sq_dists(x[rows], x[cols])
        count += (d2 <= r2).sum(dim=1)
        key = (d2.view(torch.int32).long() << 32) | cols
        ok = (d2 > 0.0) & torch.isfinite(d2)
        lower = fe_t[cols][None, :] < fe_t[rows][:, None]
        for side, gate in ((0, ok), (1, ok & lower)):
            keys[side] = torch.minimum(
                keys[side], torch.where(gate, key, KEY_NONE).amin(dim=1))
        adj = ((d2 < float(md2)) & below[rows][:, None]
               & below[cols][None, :])
        n_adj += adj.sum()
        bad_lab += (adj & (lab[cols][None, :] != lab[rows][:, None])).sum()
    d2, ids = unpack_keys(keys)
    absent = ~(d2 < float("inf"))
    ids = torch.where(absent, 0, ids).cpu().numpy()
    d2 = torch.where(absent, 0.0, d2).cpu().numpy()
    i = pick.numpy()
    bad = {"populations": int((count.cpu().numpy() != pops[i]).sum())}
    for side, name in ((0, "nn"), (1, "lower-fe nn")):
        bad[f"{name} ids"] = int((ids[side] != nn[2 * side][i]).sum())
        bad[f"{name} d2 bits"] = int(
            (d2[side].view(np.int32)
             != np.asarray(nn[2 * side + 1], np.float32)[i].view(np.int32))
            .sum())
    bad["labels"] = int(bad_lab)
    print(f"[{where}] sampled check, {N_SAMPLE} frames against all {n}:"
          f" mismatches {json.dumps(bad)}; {int(absent[1].sum())} of them"
          f" without a lower-fe neighbour, {int(below[rows].sum())} labelled"
          f" at {THRESHOLDS[-1]} with {int(n_adj)} admissible pairs")
    if any(bad.values()):
        fail("the sampled check disagrees with the engines")


@contextlib.contextmanager
def kernel_events(names):
    """CUDA events around every call of the named kernels' wrappers while
    the block runs, on the current stream (no host sync); yields {name:
    [(start, end, pairs), ...]}, to be read after a synchronize: ``pairs``
    is the call's evaluated pairs (:func:`evaluated_tiles` x row_block x
    col_block), a device tensor."""
    import torch
    from clustering_tpu_torch.ops import kernels
    events = {name: [] for name in names}
    saved = {name: getattr(kernels, name) for name in names}

    def timed_call(name, fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            pairs = evaluated_tiles(name, args) * (args[-2] * args[-1])
            events[name].append((start, end, pairs))
            return out
        return call

    for name, fn in saved.items():
        setattr(kernels, name, timed_call(name, fn))
    try:
        yield events
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


@contextlib.contextmanager
def host_rss(period=0.02):
    """Sample this process's resident set (``/proc/self/statm``) every
    ``period`` seconds on a thread while the block runs; yields a dict
    whose ``"text"``, after the block, reports the largest sample (or
    "not measured" where statm cannot be read) beside ``getrusage``'s
    peak of the whole process."""
    import resource
    import threading
    page = os.sysconf("SC_PAGE_SIZE")
    got, stop = {"peak": None}, threading.Event()

    def sample():
        while True:
            try:
                with open("/proc/self/statm") as fh:
                    rss = int(fh.read().split()[1]) * page
            except (OSError, ValueError, IndexError):
                return
            got["peak"] = max(got["peak"] or 0, rss)
            if stop.wait(period):
                return

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield got
    finally:
        stop.set()
        thread.join()
        peak = ("not measured" if got["peak"] is None
                else f"{got['peak']} bytes")
        maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        got["text"] = (f"host peak RSS {peak} (sampled every"
                       f" {period * 1e3:.0f} ms), getrusage ru_maxrss"
                       f" {maxrss} bytes (the process so far)")


def finish_ab(eng, pops, order_name):
    """The populations' two host finishes on one padded download rebuilt
    from ``pops`` in the layout ``order_name`` of the engine ``eng``: the
    native pass and the numpy scatter + cast, in turns native, numpy,
    numpy, native, each equal to ``pops``. Returns {finish: [s, s]}."""
    from clustering_tpu_torch.ops import engine
    order = eng._layout(order_name)
    counts = np.zeros((1, eng.n_pad), dtype=np.int32)
    counts[0, :eng.n] = pops[order]
    native = engine.textio_native.pops_finish
    secs = {"native": [], "numpy": []}
    for want in ("native", "numpy", "numpy", "native"):
        engine.textio_native.pops_finish = (
            native if want == "native" else lambda *args: None)
        try:
            t0 = time.perf_counter()
            out, how = eng._pops_finish(counts, order, [RADIUS])
            secs[how].append(time.perf_counter() - t0)
        finally:
            engine.textio_native.pops_finish = native
        if how != want or not np.array_equal(out[RADIUS], pops):
            fail(f"the {want} populations finish does not give the run's"
                 " populations")
    return secs


def upper_tiles(n_pad, rb, cb):
    """Tiles of the (n_pad / rb, n_pad / cb) grid that meet the strict
    upper triangle (``pruning.upper_mask``), in closed form."""
    nrb, ncb = n_pad // rb, n_pad // cb
    return int((ncb - (np.arange(nrb, dtype=np.int64) * rb) // cb).sum())


def phase_big_n(torch, smi):
    """The engines at N_BIG: every stage planned on the device, the three
    bidirectional kernels launched, the output invariants, the sampled
    exact check, the tier check and the plan check. Prints the stage
    walls and plans, the populations' host finish, the tier split, each
    kernel's ms, launches, pairs and share of the FP32 bound, the peak
    device memory per stage and the host's peak RSS. Returns the
    coordinates and the run's (pops, nn, clusterings), on the host."""
    from clustering_tpu_torch.ops import kernels
    from clustering_tpu_torch.ops.density import free_energies
    coords = synthetic_fel(N_BIG, DIM, seed=0)
    stats, keep, mem = {}, {}, {}
    with host_rss() as rss, kernel_events(BIDIR_KERNELS) as events:
        kernels.reset_launches()
        pops, nn, clust, walls, _ = run_engines(torch, coords, stats, keep,
                                                mem=mem)
        launches = {name: kernels.LAUNCHES[name] for name in BIDIR_KERNELS}
        torch.cuda.synchronize()
    print(f"[big N] {smi}; the run's {rss['text']}")
    tag = f"N={N_BIG} D={DIM}"
    plans, tiles = plan_report(tag, walls, stats)
    st = stats["populations"]
    eng = keep["engine"]
    print(f"[big N] {tag}: populations finished by the {st['finish']} pass"
          f" in {st['t_finish']:.3f}s; the same download finished native /"
          f" numpy in turns {json.dumps(finish_ab(eng, pops, st['order']))}"
          f" s; peak device memory per stage {json.dumps(mem)}, run"
          f" {max(mem.values())} bytes (the peak statistics reset as each"
          " stage starts)")
    nn_st = stats["nearest neighbors"]
    upper = upper_tiles(eng.n_pad, eng.row_block, eng.col_block)
    print(f"[big N] {tag}: NN {nn_st['mode']} phase 2, frames per tier"
          f" {nn_st.get('tier_frames')}, taus {nn_st.get('taus')}; band"
          f" {nn_st['band_tiles']} and phase 2 {nn_st['phase2_tiles']} of"
          f" the {upper} upper-triangular tiles"
          f" ({nn_st['phase2_tiles'] / upper:.4f})")
    total_ms = 0.0
    for name, ev in events.items():
        ms = sum(a.elapsed_time(b) for a, b, _ in ev)
        pairs = int(sum(p for _, _, p in ev)) if ev else 0
        bound = pairs * 3 * DIM / PEAK_FLOPS * 1e3
        total_ms += ms
        print(f"[big N] {tag}: {name} {launches[name]} launches, {pairs}"
              f" pairs, kernel {ms:.3f} ms, FP32 bound {bound:.3f} ms,"
              f" share {bound / ms if ms else 0.0:.3f}")
    print(f"[big N] {tag}: kernels {total_ms / 1e3:.3f} s of"
          f" {sum(walls.values()):.3f} s of stage walls; tiles"
          f" {json.dumps(tiles)}")
    if set(plans.values()) != {"device"}:
        fail(f"a stage at N={N_BIG} was not planned on the device: {plans}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched at N={N_BIG}")
    if st["finish"] != "native":
        fail(f"the populations at N={N_BIG} were finished by the"
             f" {st['finish']} pass")
    fe = free_energies(pops)
    check_outputs("big N", N_BIG, pops, fe, np.stack([nn[0], nn[2]], 1),
                  np.stack([nn[1], nn[3]], 1), clust[-1])
    sampled_check(torch, coords, pops, fe, nn, clust[-1], keep["md2"])
    print(f"[big N] screener built during NN in {keep['screener_build']:.3f}s")
    tier_check(torch, f"N={N_BIG}", keep, nn, stats, walls)
    plan_check(torch, f"N={N_BIG}", eng, keep["series"], keep["md2"], nn)
    return coords, (pops, nn, clust)


# -- phase 10 ------------------------------------------------------------------

# (ranks, bidirectional switches) of the co-located gloo runs
MESH_RUNS = ((2, True), (4, True), (2, False))
MESH_TIMEOUT = 300


def mesh_rank(rank, world, store, bidir, out, per_rank=1):
    """One gloo rank of phase 10 (13 with ``per_rank`` > 1) on cuda:0, its
    mesh over cuda:0 named ``per_rank`` times: the engines at N_MAIN over
    the mesh (``run_engines``) twice, the first run in a fresh process
    (cold), then again (warm), with identical results; every merge and
    every ``all_reduce`` timed between two synchronizes. Writes the warm
    run's results, stats and launches, and both runs' walls, merge and
    reduce totals, to ``out``."""
    import torch
    import torch.distributed as dist
    from clustering_tpu_torch.ops import kernels
    from clustering_tpu_torch.ops.engine import DensityEngine
    from clustering_tpu_torch.parallel import mesh as pmesh
    pmesh.initialize("cuda:0", backend="gloo", init_method="file://" + store,
                     world_size=world, rank=rank)
    try:
        mesh = pmesh.make_mesh(devices=["cuda:0"] * per_rank)
        all_reduce = dist.all_reduce
        reduce = []

        def timed_all_reduce(t, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            work = all_reduce(t, *args, **kw)
            torch.cuda.synchronize()
            reduce[-1]["seconds"] += time.perf_counter() - t0
            reduce[-1]["calls"] += 1
            reduce[-1]["bytes"] += t.numel() * t.element_size()
            return work

        dist.all_reduce = timed_all_reduce
        coords = synthetic_fel(N_MAIN, DIM, seed=0)
        runs, merges = [], []
        for _ in ("cold", "warm"):
            stats = {}
            reduce.append({"calls": 0, "seconds": 0.0, "bytes": 0})
            # phase 6's tier_qs: a mesh keeps the row-side route block-bound
            qs = "auto" if bidir else DensityEngine.TIER_QS_DEFAULT
            with bidir_switches(bidir), timed_merges(torch,
                                                     pmesh.Mesh) as tally:
                kernels.reset_launches()
                runs.append(run_engines(torch, coords, stats, mesh=mesh,
                                        tier_qs=qs))
            merges.append(tally)
        same_results(runs[0], runs[1], f"rank {rank}'s cold and warm runs")
        pops, nn, clust, _, modes = runs[1]
        meta = {"walls": [run[3] for run in runs], "modes": modes,
                "nn_mode": stats["nearest neighbors"]["mode"],
                "reduce": reduce, "merges": merges,
                "launches": dict(kernels.LAUNCHES),
                "shares": stage_tiles(stats, share=True),
                "layout": [mesh.offset, mesh.size]}
        if per_rank > 1:
            meta["want_launches"] = mesh_launches(
                BIDIR_KERNELS if bidir else SPARSE_KERNELS, stats)
        np.savez(out, pops=pops, nn_ids=np.stack([nn[0], nn[2]]),
                 nn_d2=np.stack([nn[1], nn[3]]), clust=np.stack(clust),
                 meta=json.dumps(meta))
    finally:
        dist.destroy_process_group()


def spawn_ranks(torch, world, bidir, tmp, per_rank=1):
    """Start ``world`` gloo ranks (``mesh_rank``) sharing cuda:0, each
    over ``per_rank`` devices, with a FileStore rendezvous in ``tmp``;
    fail if one fails or any is alive after MESH_TIMEOUT (all are killed
    then). Returns each rank's (results, meta) and the wall of the whole
    run."""
    ctx = torch.multiprocessing.get_context("spawn")
    tag = f"{world}{int(bidir)}{per_rank}"
    store = os.path.join(tmp, f"store{tag}")
    outs = [os.path.join(tmp, f"mesh{tag}_{r}.npz") for r in range(world)]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=mesh_rank,
                         args=(r, world, store, bidir, outs[r], per_rank))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.perf_counter() - t0 > MESH_TIMEOUT:
                fail(f"a mesh rank of {world} hangs after {MESH_TIMEOUT}s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    wall = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        fail(f"mesh ranks of {world} exited {codes}")
    ranks = []
    for out in outs:
        with np.load(out) as f:
            ranks.append(({k: f[k] for k in f.files if k != "meta"},
                          json.loads(str(f["meta"]))))
    return ranks, wall


def rank_checks(tag, rank, got, meta, route, want_nn, want):
    """Fail unless a mesh rank's run (``got``, ``meta``) took ``route`` on
    every stage and NN's phase 2 of ``want_nn``, and its results equal
    ``want`` (phase 6's run)."""
    if set(meta["modes"].values()) != {route + "-mesh"}:
        fail(f"{tag}: rank {rank} took another route: {meta['modes']}")
    if meta["nn_mode"] != want_nn["mode"]:
        fail(f"{tag}: rank {rank}'s NN phase 2 was {meta['nn_mode']}, not"
             f" {want_nn['mode']}")
    same_results(
        (got["pops"], (got["nn_ids"][0], got["nn_d2"][0], got["nn_ids"][1],
                       got["nn_d2"][1]), list(got["clust"])),
        want, f"{tag}: rank {rank} and phase 6")


def phase_mesh(torch, runs, tmp, smi):
    """Co-located gloo ranks on cuda:0 against phase 6's runs (``runs``),
    then the CLI under NCCL at world size 1 against phase 5's files."""
    for world, bidir in MESH_RUNS:
        route = "bidir" if bidir else "symmetric"
        pops, nn, clust, _, _, _, stats = runs[route]
        want_tiles = stage_tiles(stats)
        # the bidirectional list tiers as on one rank; the row-side route
        # sweeps block-bound on a mesh
        want_nn = stats["nearest neighbors" if bidir else "nn block-bound"]
        want_tiles["nn phase 2"] = want_nn["phase2_tiles"]
        ranks, wall = spawn_ranks(torch, world, bidir, tmp)
        tag = f"[mesh] {world} gloo ranks on cuda:0, {route}"
        print(f"{tag}: {smi}; N={N_MAIN} D={DIM}, {wall:.3f}s from spawn to"
              " join")
        for run, walls in zip(("cold", "warm"), ranks[0][1]["walls"]):
            print(f"{tag}: rank 0 stages, {run} run {json.dumps(walls)}")
        for rank, (got, meta) in enumerate(ranks):
            red = ", ".join(f"{run} {r['calls']} calls, {r['bytes']} bytes,"
                            f" {r['seconds']:.4f}s" for run, r
                            in zip(("cold", "warm"), meta["reduce"]))
            print(f"{tag}: rank {rank} all_reduce {red}; tiles"
                  f" {json.dumps(meta['shares'])}; launches"
                  f" {json.dumps(meta['launches'])}")
            rank_checks(tag, rank, got, meta, route, want_nn,
                        (pops, nn, clust))
            on, off = ((BIDIR_KERNELS, SPARSE_KERNELS) if bidir
                       else (SPARSE_KERNELS, BIDIR_KERNELS))
            shares = meta["shares"]
            swept = {on[0]: shares["populations"],
                     on[1]: shares["nn band"] + shares["nn phase 2"],
                     on[2]: sum(shares[f"screening {t}"]
                                for t in THRESHOLDS)}
            for name in on:
                if swept[name] and meta["launches"][name] <= 0:
                    fail(f"{tag}: {name} not launched on rank {rank}")
            for name in off:
                if meta["launches"][name]:
                    fail(f"{tag}: {name} launched on rank {rank}")
        for stage, total in want_tiles.items():
            shares = [meta["shares"][stage] for _, meta in ranks]
            if sum(shares) != total:
                fail(f"{tag}: {stage} shares {shares} do not split its"
                     f" {total} tiles")
        print(f"{tag}: populations, nn ids, nn distances (bit for bit) and"
              f" {len(THRESHOLDS)} clusterings identical to phase 6 on every"
              f" rank; NN phase 2 {want_nn['mode']}; shares sum to phase"
              " 6's tiles " + json.dumps(want_tiles))
    phase_nccl_cli(tmp)


def cli_process(tmp, name, distributed=False, env_extra=None, code=None):
    """The density CLI at phase 5's argv on phase 5's coordinates, in a
    process of its own in ``tmp``/``name``, under the distributed switches
    at world size 1 if ``distributed``, with the variables ``env_extra``,
    run by ``python -c code`` if given (the code takes the argv from
    ``sys.argv[1:]``); fails unless its files are byte-identical to phase
    5's (but for the time stamp). Returns its stdout, its wall and its
    stage walls."""
    import socket
    import sys
    main_dir, d = os.path.join(tmp, "main"), os.path.join(tmp, name)
    os.makedirs(d)
    os.link(os.path.join(main_dir, "coords.dat"),
            os.path.join(d, "coords.dat"))
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    env.pop("CLUSTERING_TORCH_DEVICE", None)
    env.update(env_extra or {})
    if distributed:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env.update(CLUSTERING_TPU_DISTRIBUTED="1",
                   CLUSTERING_TPU_COORDINATOR=f"localhost:{port}",
                   CLUSTERING_TPU_NUM_PROCESSES="1",
                   CLUSTERING_TPU_PROCESS_ID="0")
    t0 = time.perf_counter()
    run = (["-m", "clustering_tpu_torch"] if code is None
           else ["-c", code])
    proc = subprocess.run(
        [sys.executable] + run + ARGV, cwd=d, env=env,
        capture_output=True, text=True, timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"the CLI process {name} exited {proc.returncode}:\n"
             f"{proc.stdout}\n{proc.stderr}")
    same_files(main_dir, d, f"the CLI process {name}")
    walls = stage_walls(proc.stdout)
    return proc.stdout, wall, walls


def same_files(main_dir, d, what):
    """Fail unless ``d`` holds the files of phase 5's ``main_dir``, byte
    for byte but for the time stamp; ``what`` names the run."""
    names = sorted(os.listdir(main_dir))
    if sorted(os.listdir(d)) != names:
        fail(f"{what} wrote {sorted(os.listdir(d))}, not {names}")
    for file in names:
        lines = []
        for where in (main_dir, d):
            with open(os.path.join(where, file), "rb") as fh:
                lines.append([ln for ln in fh.read().splitlines()
                              if not ln.startswith(b"# Created ")])
        if lines[0] != lines[1]:
            fail(f"{file} differs between phase 5 and {what}")


def phase_nccl_cli(tmp):
    """The density CLI in a process of its own, first plain, then under
    the distributed switches with NCCL at world size 1: both write phase
    5's files, and the second must run as rank 0 of 1 under NCCL on the
    mesh route."""
    for name, distributed in (("plain", False), ("nccl", True)):
        out, wall, walls = cli_process(tmp, name, distributed)
        if distributed:
            rank_line = re.search(r"~~~ rank 0 of 1 \((\w+)\)", out)
            if rank_line is None or rank_line.group(1) != "nccl":
                fail("the CLI did not run as rank 0 of 1 under NCCL")
            if out.count("[mesh screening fixpoint") < len(THRESHOLDS):
                fail("the NCCL CLI run did not take the mesh route")
        what = ("NCCL, world size 1" if distributed
                else "no process group")
        print(f"[mesh] CLI process, {what}: {wall:.3f}s of process, stages"
              f" {json.dumps(walls)}; files byte-identical to phase 5's")


# -- phase 11 ------------------------------------------------------------------

COLD_RUNS = (("off", {"CLUSTERING_TPU_DEVICE_WARM": "0",
                      "CLUSTERING_TPU_PRECOMPILE": "0"}),
             ("on", {}), ("on", {}),
             ("off", {"CLUSTERING_TPU_DEVICE_WARM": "0",
                      "CLUSTERING_TPU_PRECOMPILE": "0"}))
STAGES = (["populations", "nearest neighbors", "screening setup"]
          + [f"screening {t}" for t in THRESHOLDS])
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def warm_check(torch, keep, out):
    """Phase 11 (e), on phase 6's bidirectional engines (``keep``, the run's
    result ``out``): the three warms launch their stages' kernels, and
    populations, NN and the series run again after them give phase 6's
    results."""
    from clustering_tpu_torch.ops import kernels
    eng, series, md2 = keep["engine"], keep["series"], keep["md2"]
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    eng.precompile_pops([RADIUS])
    eng.precompile_nn()
    series.precompile(md2)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    launched = {name: kernels.LAUNCHES[name] - before[name]
                for name in BIDIR_KERNELS}
    for name, count in launched.items():
        if count <= 0:
            fail(f"the warms launched no {name}")
    pops = eng.populations([RADIUS])[RADIUS]
    nn = eng.nearest_neighbors(keep["fe"])
    series.reset()
    clust, prev = [], None
    for k in range(len(THRESHOLDS)):
        prev = series.step(prev, k, md2)
        clust.append(prev)
    same_results(out, (pops, nn, clust),
                 "phase 6's run and its rerun after the warms")
    print(f"[warms] precompile_pops, precompile_nn and series.precompile on"
          f" phase 6's engines in {t_warm:.3f}s, launches"
          f" {json.dumps(launched)}; populations, NN and"
          f" {len(THRESHOLDS)} clusterings after them identical to phase 6")


def phase_cold_cli(tmp):
    """Phase 11 (a): cold CLI processes, warms off, on, on, off."""
    for i, (label, env) in enumerate(COLD_RUNS):
        out, wall, walls = cli_process(tmp, f"cold{i}",
                                       env_extra=dict(env,
                                                      **{SUBSTAGES_ENV: "1"}))
        subs = substages(out)
        if ("t_device_warm" in subs.get("populations", "")) != (label == "on"):
            fail(f"the device warm's seconds do not match warms {label}")
        print(f"[cold CLI] run {i + 1}, warms {label}: {wall:.3f}s of"
              f" process; populations {walls['populations']:.3f}s, NN"
              f" {walls['nearest neighbors']:.3f}s, set-up"
              f" {walls['screening setup']:.3f}s; substages"
              f" {json.dumps(subs)}; files byte-identical to phase 5's")


def _busy(intervals, lo, hi):
    """Seconds of the union of sorted (start, end) intervals (us) inside
    [lo, hi]."""
    total, reach = 0.0, lo
    for a, b in intervals:
        a, b = max(a, reach), min(b, hi)
        if b > a:
            total += b - a
            reach = b
    return total / 1e6


def phase_profile(tmp):
    """Phase 11 (b): a profiled CLI process; the device's busy time and
    idle share inside the stages, from its Chrome trace."""
    from collections import Counter
    trace_dir = os.path.join(tmp, "profile")
    _, wall, _ = cli_process(
        tmp, "profiled", env_extra={"CLUSTERING_TPU_PROFILE": trace_dir})
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation" and e["name"] in STAGES}
    if sorted(spans) != sorted(STAGES):
        fail(f"the trace's stage annotations are {sorted(spans)}")
    lo = min(e["ts"] for e in spans.values())
    hi = max(e["ts"] + e["dur"] for e in spans.values())
    device = [e for e in events if e.get("cat") in DEVICE_EVENTS
              and e.get("ph") == "X" and lo <= e["ts"] < hi]
    kernels_seen = {name for name in BIDIR_KERNELS for e in device
                    if e["cat"] == "kernel" and f"{name}_kernel" in e["name"]}
    if not any(e["cat"] == "kernel" for e in device):
        fail("the trace holds no CUDA kernel event inside the stages")
    if kernels_seen != set(BIDIR_KERNELS):
        fail(f"the trace shows only {sorted(kernels_seen)} of the"
             " bidirectional kernels")
    intervals = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy = _busy(intervals, lo, hi)
    window = (hi - lo) / 1e6
    per_stage = {name: round(1.0 - _busy(intervals, e["ts"],
                                         e["ts"] + e["dur"])
                             / max(e["dur"] / 1e6, 1e-12), 4)
                 for name, e in spans.items()}
    ms, count = Counter(), Counter()
    for e in device:
        ms[e["name"]] += e["dur"] / 1e3
        count[e["name"]] += 1
    top = [{"name": name[:80], "ms": round(t, 3), "count": count[name]}
           for name, t in ms.most_common(5)]
    print(f"[profile] {wall:.3f}s of process, files byte-identical to phase"
          f" 5's; window {window:.3f}s from the first stage annotation to the"
          f" last, device busy {busy:.3f}s ({len(device)} kernel, memcpy and"
          f" memset events), idle share {1.0 - busy / window:.4f}")
    print(f"[profile] idle share per stage {json.dumps(per_stage)}")
    print(f"[profile] top device ops {json.dumps(top)}")


def phase_screening_step(torch, tmp, coords, fe, nn):
    """Phase 11 (c): ``screening_step`` over phase 5's thresholds on its
    coordinates, free energies and neighbour distances (from
    ``cli_files_check``), incremental, the FE order, sorted coordinates and
    engine reused; the clusterings must equal phase 5's files."""
    from clustering_tpu_torch.models.density import (screening_step,
                                                     sorted_fe_order)
    from clustering_tpu_torch.ops.screening import ScreeningEngine
    t0 = time.perf_counter()
    order = sorted_fe_order(fe)
    cs = coords[order]
    eng = ScreeningEngine(cs, device="cuda")
    prev, walls = None, {}
    for t in THRESHOLDS:
        t1 = time.perf_counter()
        prev = screening_step(fe, nn[1], float(t), coords, prev, order=order,
                              coords_sorted=cs, engine=eng,
                              incremental=prev is not None)
        walls[t] = round(time.perf_counter() - t1, 3)
        want = np.loadtxt(os.path.join(tmp, "main", f"clust.{t}"),
                          dtype=np.int64)
        if not np.array_equal(prev, want):
            fail(f"screening_step at {t} differs from phase 5's clust.{t}")
    torch.cuda.synchronize()
    print(f"[screening_step] N={len(fe)}: {time.perf_counter() - t0:.3f}s,"
          f" steps {json.dumps(walls)} (FE-ordered engine, last step"
          f" {eng.last_stats['tiles_per_sweep']} tiles/sweep,"
          f" {eng.last_stats['sweeps']} sweeps); {len(THRESHOLDS)}"
          " clusterings identical to phase 5's files")


def phase_unpruned(torch, smi):
    """Phase 11 (d): the unpruned route at N_KERNELS against the pruned
    default route, its two row-side kernels held against their plain
    versions on the route's own calls."""
    from clustering_tpu_torch.ops import kernels
    from clustering_tpu_torch.ops.density import free_energies, populations
    from clustering_tpu_torch.ops.neighbors import nearest_neighbors
    coords = synthetic_fel(N_KERNELS, DIM, seed=3)
    pops = populations(coords, [RADIUS])[RADIUS]
    fe = free_energies(pops)
    nn = nearest_neighbors(coords, fe)
    names = ("pops_sparse", "nn_sparse")
    with record_calls(names) as calls:
        kernels.reset_launches()
        t0 = time.perf_counter()
        pops_u = populations(coords, [RADIUS], prune=False)[RADIUS]
        with bidir_switches(False):
            nn_u = nearest_neighbors(coords, fe, prune=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: kernels.LAUNCHES[name] for name in names}
    for name in names:
        if launches[name] <= 0:
            fail(f"the unpruned route did not launch {name}")
    same_results((pops, nn, []), (pops_u, nn_u, []),
                 "the pruned and unpruned routes")
    held = {}
    for name in names:
        fn = getattr(kernels, name)
        got, ms = replay(torch, name, fn, calls[name])
        want, plain_ms = replay(torch, name, getattr(kernels, name + "_plain"),
                                calls[name])
        bad, err = compare_outputs(torch, got, want)
        if bad:
            fail(f"{name} disagrees with its plain version on the unpruned"
                 f" route ({bad} elements)")
        held[name] = {"launches": launches[name], "ms": round(ms, 3),
                      "plain_ms": round(plain_ms, 3), "max_abs_err": err}
    print(f"[unpruned] {smi}, N={N_KERNELS}: populations(prune=False) and"
          f" nearest_neighbors(prune=False) in {wall:.3f}s, equal to the"
          f" pruned route; kernels against plain versions {json.dumps(held)}")


# -- phase 12 ------------------------------------------------------------------

# the local meshes held on the one card: its device named k times, in
# turns with the one device (1: no mesh) in the same state of the process
LOCAL_SIZES = (2, 4)
LOCAL_TURNS = (1, 2, 4, 1)
# the per-tile arguments of each bidirectional wrapper (ti first), dealt
# into shares
PER_TILE = {"pops_bidir": (3, 4, 5), "nn_bidir": (4, 5),
            "label_min_bidir": (4, 5, 6)}


def phase_share_holds(torch, calls, smi):
    """Phase 12 (b), run right after phase 8 on the calls phase 5 recorded:
    each bidirectional kernel on share 1 of 2 of every call's tile list
    (the tiles of the odd row blocks, as a local mesh of two deals them)
    against its plain version on the same inputs, exact."""
    from clustering_tpu_torch.ops import kernels
    held = {}
    for name in BIDIR_KERNELS:
        rec = []
        for args, kw in calls[name]:
            args = list(args)
            odd = args[PER_TILE[name][0]] % 2 == 1
            for i in PER_TILE[name]:
                args[i] = args[i][odd].contiguous()
            rec.append((tuple(args), kw))
        got, ms = replay(torch, name, getattr(kernels, name), rec)
        want, plain_ms = replay(torch, name,
                                getattr(kernels, name + "_plain"), rec)
        bad, err = compare_outputs(torch, got, want)
        if bad:
            fail(f"{name} disagrees with its plain version on share 1 of 2"
                 f" of phase 5's calls ({bad} elements)")
        held[name] = {"calls": len(rec),
                      "tiles": sum(len(args[PER_TILE[name][0]])
                                   for args, _ in rec),
                      "ms": round(ms, 3), "plain_ms": round(plain_ms, 3),
                      "max_abs_err": err}
    print(f"[local mesh] {smi}: share 1 of 2 of phase 5's calls, kernels"
          f" against plain versions (exact) {json.dumps(held)}")


@contextlib.contextmanager
def timed_merges(torch, cls=None):
    """Every merge of a mesh class (``cls``, default ``LocalMesh``: its
    ``sum`` and ``min``) timed between two synchronizes while the block
    runs; yields {"calls": n, "seconds": s}."""
    from clustering_tpu_torch.parallel.mesh import LocalMesh
    cls = LocalMesh if cls is None else cls
    tally = {"calls": 0, "seconds": 0.0}
    saved = {name: getattr(cls, name) for name in ("sum", "min")}

    def timed(fn):
        def merge(self, parts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, parts)
            torch.cuda.synchronize()
            tally["seconds"] += time.perf_counter() - t0
            tally["calls"] += 1
            return out
        return merge

    for name, fn in saved.items():
        setattr(cls, name, timed(fn))
    try:
        yield tally
    finally:
        for name, fn in saved.items():
            setattr(cls, name, fn)


def mesh_launches(route_kernels, stats):
    """The launches a local mesh's run must make, from its ``stats``: per
    stage call, one per device with a non-empty share."""
    nonempty = [sum(1 for n in shares if n)
                for shares in stage_tiles(stats, share=True).values()]
    n_pops, n_band, n_phase2 = nonempty[:3]
    sweeps = sum(stats[f"screening {t}"]["sweeps"] * n
                 for t, n in zip(THRESHOLDS, nonempty[3:]))
    return dict(zip(route_kernels, (n_pops, n_band + n_phase2, sweeps)))


def phase_local_mesh(torch, runs, smi):
    """Phase 12 (a): phase 6's configuration through the engines on local
    meshes over cuda:0 named 2 and 4 times, on both routes, against phase
    6's runs (``runs``), in turns with the one device (LOCAL_TURNS) on NN's
    phase 2 of the meshes, for stage walls taken in one state. Returns
    each route's shares on the mesh of 4, by stage."""
    from clustering_tpu_torch.ops import kernels
    from clustering_tpu_torch.ops.engine import DensityEngine
    from clustering_tpu_torch.parallel import make_mesh
    coords = synthetic_fel(N_MAIN, DIM, seed=0)
    four = {}
    for route, bidir in (("bidir", True), ("symmetric", False)):
        pops, nn, clust, _, _, _, stats = runs[route]
        want_tiles = stage_tiles(stats)
        # the bidirectional list tiers as on one device; the row-side
        # route sweeps block-bound on a mesh
        want_nn = stats["nearest neighbors" if bidir else "nn block-bound"]
        want_tiles["nn phase 2"] = want_nn["phase2_tiles"]
        on, off = ((BIDIR_KERNELS, SPARSE_KERNELS) if bidir
                   else (SPARSE_KERNELS, BIDIR_KERNELS))
        turns = []
        for k in LOCAL_TURNS:
            tag = f"[local mesh] cuda:0 x {k}, {route}"
            st = {}
            qs = "auto" if bidir else DensityEngine.TIER_QS_DEFAULT
            mesh = None if k == 1 else make_mesh(devices=["cuda:0"] * k)
            if mesh is None and not bidir:
                qs = None  # the meshes' block-bound phase 2
            with bidir_switches(bidir), timed_merges(torch) as merges:
                kernels.reset_launches()
                out = run_engines(torch, coords, st, mesh=mesh, tier_qs=qs)
                launches = {name: kernels.LAUNCHES[name]
                            for name in on + off}
            turns.append((k, out[3]))
            same_results(out, (pops, nn, clust),
                         f"the local mesh of {k} ({route}) and phase 6")
            if mesh is None:
                continue
            shares = stage_tiles(st, share=True)
            if k == 4:
                four[route] = shares
            print(f"{tag}: {smi}; N={N_MAIN} D={DIM}, stages"
                  f" {json.dumps(out[3])}; {merges['calls']} merges in"
                  f" {merges['seconds']:.4f}s; shares {json.dumps(shares)};"
                  f" launches {json.dumps(launches)}")
            if set(out[4].values()) != {route + "-mesh"}:
                fail(f"{tag}: another route was taken: {out[4]}")
            if st["nearest neighbors"]["mode"] != want_nn["mode"]:
                fail(f"{tag}: NN phase 2 was"
                     f" {st['nearest neighbors']['mode']}, not"
                     f" {want_nn['mode']}")
            for stage, total in want_tiles.items():
                got = shares[stage]
                if len(got) != k or sum(got) != total:
                    fail(f"{tag}: {stage} shares {got} do not split its"
                         f" {total} tiles over {k} devices")
            want = dict(mesh_launches(on, st), **{name: 0 for name in off})
            if launches != want:
                fail(f"{tag}: launches {launches}, not one per device per"
                     f" call with a non-empty share: {want}")
        print(f"[local mesh] {route}: stage walls in turns, devices"
              f" {'/'.join(str(k) for k, _ in turns)}: " + json.dumps(
                  {stage: "/".join(f"{w[stage]:.3f}" for _, w in turns)
                   for stage in turns[0][1]}))
        print(f"[local mesh] {route}: populations, nn ids, nn distances (bit"
              f" for bit) and {len(THRESHOLDS)} clusterings identical to"
              f" phase 6 on {' and '.join(map(str, LOCAL_SIZES))} devices;"
              f" shares sum to phase 6's tiles {json.dumps(want_tiles)}")
    return four


def phase_local_cli(torch, tmp):
    """Phase 12 (c): the density CLI in this process at phase 5's argv on
    its coordinates, the visible devices (``parallel.mesh.
    visible_devices``) patched to cuda:0 twice: it must mesh them and
    write phase 5's files, byte for byte."""
    from clustering_tpu_torch.ops import kernels
    from clustering_tpu_torch.parallel import mesh as pmesh
    d = os.path.join(tmp, "local_cli")
    os.makedirs(d)
    os.link(os.path.join(tmp, "main", "coords.dat"),
            os.path.join(d, "coords.dat"))
    saved = pmesh.visible_devices
    pmesh.visible_devices = lambda device="cuda": [torch.device("cuda",
                                                                0)] * 2
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = run_cli(d, None, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pmesh.visible_devices = saved
    if "~~~ mesh of 2 devices: cuda:0, cuda:0" not in out:
        fail("the CLI did not mesh the patched devices")
    if out.count("[mesh screening fixpoint") < len(THRESHOLDS):
        fail("the CLI's screening did not run on the mesh")
    same_files(os.path.join(tmp, "main"), d,
               "the CLI on a local mesh of cuda:0 x 2")
    walls = stage_walls(out)
    launches = {name: kernels.LAUNCHES[name] for name in BIDIR_KERNELS}
    print(f"[local mesh] CLI in-process on cuda:0 x 2: {wall:.3f}s, stages"
          f" {json.dumps(walls)}, launches {json.dumps(launches)}; files"
          " byte-identical to phase 5's")


def phase_local_big(torch, big, smi):
    """Phase 12 (d): the engines at N_BIG on a local mesh of cuda:0 twice,
    default route: phase 9's results bit for bit, its invariants and its
    sampled exact check, and the peak device memory."""
    from clustering_tpu_torch.ops import kernels
    from clustering_tpu_torch.ops.density import free_energies
    from clustering_tpu_torch.parallel import make_mesh
    coords, want = big
    torch.cuda.reset_peak_memory_stats()
    stats, keep = {}, {}
    with timed_merges(torch) as merges:
        kernels.reset_launches()
        pops, nn, clust, walls, modes = run_engines(
            torch, coords, stats, keep,
            mesh=make_mesh(devices=["cuda:0"] * 2))
        launches = {name: kernels.LAUNCHES[name] for name in BIDIR_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    print(f"[local mesh] cuda:0 x 2, N={N_BIG} D={DIM}: {smi}; stages"
          f" {json.dumps(walls)}; {merges['calls']} merges in"
          f" {merges['seconds']:.4f}s; shares"
          f" {json.dumps(stage_tiles(stats, share=True))}; launches"
          f" {json.dumps(launches)}; max_memory_allocated {peak} bytes")
    if set(modes.values()) != {"bidir-mesh"}:
        fail(f"the local mesh at N={N_BIG} took another route: {modes}")
    if launches != mesh_launches(BIDIR_KERNELS, stats):
        fail(f"the local mesh at N={N_BIG} launched {launches}")
    same_results((pops, nn, clust), want,
                 f"the local mesh of 2 and phase 9 at N={N_BIG}")
    fe = free_energies(pops)
    check_outputs("local mesh", N_BIG, pops, fe, np.stack([nn[0], nn[2]], 1),
                  np.stack([nn[1], nn[3]], 1), clust[-1])
    sampled_check(torch, coords, pops, fe, nn, clust[-1], keep["md2"],
                  where="local mesh")


def two_cards(all_cards, tag):
    """"i,j", the first two cards of ``all_cards`` (the
    CUDA_VISIBLE_DEVICES the script was started with, else every card
    ``nvidia-smi -L`` lists), or None, after a line under ``tag`` that
    says why, where fewer than two are listed or visible."""
    listed = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                            text=True, check=True).stdout.split("\n")
    listed = [ln for ln in listed if ln.startswith("GPU ")]
    cards = (all_cards.split(",") if all_cards
             else [str(i) for i in range(len(listed))])
    if len(listed) < 2 or len(cards) < 2:
        print(f"{tag} two real cards: not run: nvidia-smi -L lists"
              f" {len(listed)} card(s), {len(cards)} of them visible to this"
              " run")
        return None
    return ",".join(cards[:2])


def phase_two_cards(tmp, all_cards):
    """Phase 12 (e): where ``nvidia-smi -L`` lists more than one card, the
    density CLI in a process of its own over two real cards (the first two
    of ``all_cards``, the CUDA_VISIBLE_DEVICES the script was started
    with, else 0 and 1) against phase 5's files; else say why not."""
    pair = two_cards(all_cards, "[local mesh]")
    if pair is None:
        return
    out, wall, walls = cli_process(tmp, "two_cards",
                                   env_extra={"CUDA_VISIBLE_DEVICES": pair})
    if "~~~ mesh of 2 devices: cuda:0, cuda:1" not in out:
        fail("the CLI over two cards did not mesh them")
    print(f"[local mesh] CLI process over cards {pair}: {wall:.3f}s, stages"
          f" {json.dumps(walls)}; files byte-identical to phase 5's")


# -- phase 13 ------------------------------------------------------------------

# phase 13's group: 2 gloo ranks on the one card, each over cuda:0 named
# GROUP_PER_RANK times, so 4 devices dealt as phase 12's mesh of 4
GROUP_RANKS = 2
GROUP_PER_RANK = 2
# the CLI with the visible devices patched to cuda:0 twice
GROUP_CLI = ("import sys, torch\n"
             "from clustering_tpu_torch import cli\n"
             "from clustering_tpu_torch.parallel import mesh as pmesh\n"
             "pmesh.visible_devices = lambda device='cuda': "
             "[torch.device('cuda', 0)] * 2\n"
             "sys.exit(cli.main(sys.argv[1:]))\n")


def phase_group_mesh(torch, runs, four, tmp, smi):
    """Phase 13 (a): GROUP_RANKS gloo ranks sharing cuda:0, each with
    ``make_mesh(devices=["cuda:0"] * GROUP_PER_RANK)``, on both routes
    against phase 6's runs (``runs``): results bit for bit, each device's
    shares equal to phase 12's mesh of 4 (``four``) at its global index,
    and the route's kernels launched once per device per call with a
    non-empty share, no other."""
    for route, bidir in (("bidir", True), ("symmetric", False)):
        pops, nn, clust, _, _, _, stats = runs[route]
        want_nn = stats["nearest neighbors" if bidir else "nn block-bound"]
        ranks, wall = spawn_ranks(torch, GROUP_RANKS, bidir, tmp,
                                  GROUP_PER_RANK)
        tag = (f"[group mesh] {GROUP_RANKS} gloo ranks x cuda:0 x"
               f" {GROUP_PER_RANK}, {route}")
        print(f"{tag}: {smi}; N={N_MAIN} D={DIM}, {wall:.3f}s from spawn to"
              " join")
        for run, walls in zip(("cold", "warm"), ranks[0][1]["walls"]):
            print(f"{tag}: rank 0 stages, {run} run {json.dumps(walls)}")
        off = SPARSE_KERNELS if bidir else BIDIR_KERNELS
        for rank, (got, meta) in enumerate(ranks):
            laps = zip(("cold", "warm"), meta["merges"], meta["reduce"])
            timing = ", ".join(
                f"{run} {m['calls']} merges in {m['seconds']:.4f}s of which"
                f" all_reduce {r['calls']} calls, {r['bytes']} bytes,"
                f" {r['seconds']:.4f}s" for run, m, r in laps)
            print(f"{tag}: rank {rank} {timing}; offset/size"
                  f" {meta['layout']}; shares {json.dumps(meta['shares'])};"
                  f" launches {json.dumps(meta['launches'])}")
            offset = rank * GROUP_PER_RANK
            if meta["layout"] != [offset, GROUP_RANKS * GROUP_PER_RANK]:
                fail(f"{tag}: rank {rank}'s offset and size are"
                     f" {meta['layout']}")
            rank_checks(tag, rank, got, meta, route, want_nn,
                        (pops, nn, clust))
            for stage, shares in meta["shares"].items():
                want = four[route][stage][offset:offset + GROUP_PER_RANK]
                if shares != want:
                    fail(f"{tag}: rank {rank}'s {stage} shares {shares} are"
                         f" not phase 12's {want} at devices {offset}-"
                         f"{offset + GROUP_PER_RANK - 1}")
            want = dict(meta["want_launches"], **{name: 0 for name in off})
            got_launches = {name: meta["launches"][name] for name in want}
            if got_launches != want:
                fail(f"{tag}: rank {rank} launched {got_launches}, not one"
                     f" per device per call with a non-empty share: {want}")
        print(f"{tag}: populations, nn ids, nn distances (bit for bit) and"
              f" {len(THRESHOLDS)} clusterings identical to phase 6 on every"
              f" rank; NN phase 2 {want_nn['mode']}; each device's shares"
              " those of phase 12's mesh of 4 at its global index")


def phase_group_cli(tmp, all_cards):
    """Phase 13 (b) and (c): the density CLI in a process of its own under
    the distributed switches at world size 1 with NCCL, its visible
    devices patched to cuda:0 twice: it meshes both and writes phase 5's
    files; then, where ``nvidia-smi -L`` lists two or more cards, the same
    unpatched over two real cards (``all_cards`` as in phase 12 (e)),
    else a line that says why not."""
    out, wall, walls = cli_process(tmp, "group_cli", distributed=True,
                                   code=GROUP_CLI)
    rank_line = re.search(r"~~~ rank 0 of 1 \((\w+)\)", out)
    if rank_line is None or rank_line.group(1) != "nccl":
        fail("the group CLI did not run as rank 0 of 1 under NCCL")
    if "~~~ mesh of 2 devices: cuda:0, cuda:0" not in out:
        fail("the group CLI did not mesh the patched devices")
    if out.count("[mesh screening fixpoint") < len(THRESHOLDS):
        fail("the group CLI's screening did not run on the mesh")
    print(f"[group mesh] CLI process, NCCL, world size 1, cuda:0 x 2:"
          f" {wall:.3f}s of process, stages {json.dumps(walls)}; files"
          " byte-identical to phase 5's")
    pair = two_cards(all_cards, "[group mesh]")
    if pair is None:
        return
    out, wall, walls = cli_process(tmp, "group_two_cards", distributed=True,
                                   env_extra={"CUDA_VISIBLE_DEVICES": pair})
    if "~~~ mesh of 2 devices: cuda:0, cuda:1" not in out:
        fail("the group CLI over two cards did not mesh them")
    print(f"[group mesh] CLI process, NCCL, world size 1, cards {pair}:"
          f" {wall:.3f}s, stages {json.dumps(walls)}; files byte-identical"
          " to phase 5's")


# -- phase 14 ------------------------------------------------------------------

# the top of the users' range (PERF.md section 1): not a multiple of the
# default blocks' 4096
N_CLI_BIG = 10 ** 7
CLI_IO = ("read_coords", "write_pops", "write_fes", "write_neighborhood",
          "write_clustered_trajectory")


@contextlib.contextmanager
def cli_probe():
    """While the block runs, record what the density CLI's engine (not the
    warms' quiet scratch engines) read and returned, and the seconds of
    the CLI's text I/O calls: yields {"engine": the engine, "coords": the
    frames it holds, "pops_stats": its populations' ``last_stats``, "nn":
    what its NN returned, "io": {function: seconds summed over its
    calls}}."""
    import threading
    from clustering_tpu_torch.ops.engine import DensityEngine
    from clustering_tpu_torch.utils import io as tio
    got, lock, saved = {"io": {}}, threading.Lock(), []

    def patch(owner, attr, wrap):
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))
        setattr(owner, attr, wrap(fn))

    def pops(fn):
        def call(self, *args, **kw):
            out = fn(self, *args, **kw)
            if not self._quiet:
                got.update(engine=self, coords=self.coords,
                           pops_stats=dict(self.last_stats["populations"]))
            return out
        return call

    def nn(fn):
        def call(self, *args, **kw):
            out = fn(self, *args, **kw)
            if not self._quiet:
                got["nn"] = out
            return out
        return call

    def timed_io(name):
        def wrap(fn):
            def call(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    with lock:
                        got["io"][name] = (got["io"].get(name, 0.0)
                                           + time.perf_counter() - t0)
            return call
        return wrap

    patch(DensityEngine, "populations", pops)
    patch(DensityEngine, "nearest_neighbors", nn)
    for name in CLI_IO:
        patch(tio, name, timed_io(name))
    try:
        yield got
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def data_line_count(path):
    """Lines of a file that are not comments (``#`` first), counted on its
    bytes, not as Python strings (10^7 lines per file in phase 14)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    return (raw.count(b"\n") - raw.count(b"\n#")
            - int(raw.startswith(b"#")))


def phase_cli_big(torch, tmp, smi):
    """Phase 14: the density CLI at phase 5's argv on ``synthetic_fel`` at
    N_CLI_BIG frames, written as %.6f text by the port's native formatter
    and run in this process: exit 0, N_CLI_BIG data lines in every output
    file (read back with the port's native readers), the invariants, the
    sampled exact check on the neighbours the CLI's engine returned, the
    three bidirectional kernels launched and the native populations
    finish. Prints the stage walls, the text I/O's seconds, the peak
    device memory and the host's peak RSS."""
    from clustering_tpu_torch.ops import kernels
    from clustering_tpu_torch.ops.density import free_energies
    from clustering_tpu_torch.ops.neighbors import compute_sigma2
    from clustering_tpu_torch.utils import io as tio
    from clustering_tpu_torch.utils import textio_native
    n = N_CLI_BIG
    d = os.path.join(tmp, "cli_big")
    os.makedirs(d)
    coords = synthetic_fel(n, DIM, seed=0)
    t0 = time.perf_counter()
    text = textio_native.format_f_rows(coords, 6)
    if text is None:
        fail("the port's native text library did not load")
    with open(os.path.join(d, "coords.dat"), "wb") as fh:
        fh.write(text)
    t_write = time.perf_counter() - t0
    head = io.BytesIO()
    np.savetxt(head, coords[:1000], fmt="%.6f")
    if bytes(text[:len(head.getvalue())]) != head.getvalue():
        fail("the native %.6f text differs from np.savetxt's")
    del text, coords
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    os.environ[SUBSTAGES_ENV] = "1"
    t0 = time.perf_counter()
    try:
        with host_rss() as rss, cli_probe() as probe:
            out = run_cli(d, None, "cuda")
            torch.cuda.synchronize()
    finally:
        del os.environ[SUBSTAGES_ENV]
    wall = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in BIDIR_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    walls = stage_walls(out)
    subs = substages(out)
    names = ["pop", "fe", "nn"] + [f"clust.{t}" for t in THRESHOLDS]
    t0 = time.perf_counter()
    pops = tio.read_single_column(os.path.join(d, "pop"), dtype=int)
    fe_file = tio.read_free_energies(os.path.join(d, "fe"))
    nn_file = tio.read_neighborhood(os.path.join(d, "nn"))
    clust = tio.read_clustered_trajectory(
        os.path.join(d, f"clust.{THRESHOLDS[-1]}"))
    t_read = time.perf_counter() - t0
    lines = {name: data_line_count(os.path.join(d, name)) for name in names}
    stages = ["populations", "nearest neighbors", "screening setup"] + [
        f"screening {t}" for t in THRESHOLDS]
    tag = f"[cli big] N={n} D={DIM}"
    print(f"{tag}: {smi}; {wall:.3f}s in the CLI, stage walls"
          f" {sum(walls.get(k, 0.0) for k in stages):.3f}s"
          f" {json.dumps(walls)}; substages {json.dumps(subs)}")
    print(f"{tag}: text I/O seconds: coords.dat written (native %.6f)"
          f" {t_write:.3f}, the CLI's calls {json.dumps(probe['io'])} (the"
          f" writes on worker threads beside the stages), outputs read back"
          f" {t_read:.3f}; data lines {json.dumps(lines)}")
    print(f"{tag}: launches {json.dumps(launches)}; max_memory_allocated"
          f" {peak} bytes; the CLI's {rss['text']}")
    for stage in stages:
        if stage not in walls:
            fail(f"no wall for stage {stage!r} in the CLI at N={n}")
    if any(count != n for count in lines.values()):
        fail(f"the CLI at N={n} wrote {lines} data lines")
    for name in BIDIR_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the CLI at N={n}")
    st = probe["pops_stats"]
    print(f"{tag}: populations planned on the {st['plan']}, finished by the"
          f" {st['finish']} pass in {st['t_finish']:.3f}s; the same download"
          " finished native / numpy in turns"
          f" {json.dumps(finish_ab(probe['engine'], pops, st['order']))} s")
    if st["finish"] != "native":
        fail(f"the CLI's populations at N={n} were finished by the"
             f" {st['finish']} pass")
    nn = probe["nn"]
    for i in (0, 2):
        if not np.array_equal(nn_file[i], nn[i]):
            fail(f"the nn file's ids differ from the engine's at N={n}")
    for i in (1, 3):
        if not np.allclose(nn_file[i], nn[i], rtol=1e-5, atol=0.0):
            fail(f"the nn file's distances are not the engine's at N={n}")
    fe = free_energies(pops)
    if not np.allclose(fe_file, fe, rtol=1e-5, atol=1e-6):
        fail("fe file does not match the populations")
    check_outputs("cli big", n, pops, fe, np.stack([nn[0], nn[2]], 1),
                  np.stack([nn[1], nn[3]], 1), clust)
    md2 = np.float32(4.0 * compute_sigma2(nn[1]))
    sampled_check(torch, probe["coords"], pops, fe, nn, clust, md2,
                  where="cli big")


def main():
    t_start = time.perf_counter()

    def lap(phases):
        print(f"[time] phases {phases} done at"
              f" {time.perf_counter() - t_start:.1f}s", flush=True)

    all_cards = os.environ.get("CUDA_VISIBLE_DEVICES")
    torch, smi = phase_device()
    phase_build()
    phase_kernels(torch)
    lap("1-3")
    with tempfile.TemporaryDirectory() as tmp:
        phase_slice(tmp)
        with record_calls(BIDIR_KERNELS) as calls:
            launches = phase_main(torch, tmp)
        main_inputs = cli_files_check(torch, tmp)
        lap("4-5")
        with record_calls(SPARSE_KERNELS) as sym_calls:
            runs = phase_symmetric(torch, sym_calls)
        calls.update(sym_calls)
        for name in SPARSE_KERNELS:
            launches[name] = runs["symmetric"][5][name]
        with record_calls(TILES_KERNELS) as tiles_calls:
            tiles_launches, _ = phase_skip_words(torch, *runs["bidir"][:2])
        calls.update(tiles_calls)
        for name in TILES_KERNELS:
            launches[name] = tiles_launches[name]
        lap("6-7")
        record = {"kernels": phase_main_path_kernels(torch, calls, launches,
                                                     smi)}
        phase_share_holds(torch, calls, smi)
        del calls, sym_calls, tiles_calls
        lap("8, 12 (b)")
        big = phase_big_n(torch, smi)
        lap("9")
        phase_mesh(torch, runs, tmp, smi)
        lap("10")
        phase_cold_cli(tmp)
        phase_profile(tmp)
        phase_screening_step(torch, tmp, *main_inputs)
        del main_inputs
        phase_unpruned(torch, smi)
        lap("11")
        four = phase_local_mesh(torch, runs, smi)
        phase_local_cli(torch, tmp)
        phase_local_big(torch, big, smi)
        del big
        phase_two_cards(tmp, all_cards)
        lap("12")
        phase_group_mesh(torch, runs, four, tmp, smi)
        phase_group_cli(tmp, all_cards)
        lap("13")
        phase_cli_big(torch, tmp, smi)
        lap("14")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
