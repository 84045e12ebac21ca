"""Device-resident driver for the density pipeline's O(N^2) stages.

Counterpart of ``clustering_tpu/ops/engine.py`` on its single-chip paths:
tile sweeps over bbox-pruned tile lists, either upper-triangular
(bidirectional kernels: each unordered pair evaluated once, serving both
frames) or symmetric (row-side kernels over both orientations). The frame
matrix is uploaded once per layout; the bbox distances are computed on
the device and thresholded there. The bidirectional stages keep every
mask and tile list on the device (``pruning.*_device``); the symmetric
ones bring the bool planes to the host, where numpy plans the flat tile
lists, as in the JAX package. Both give the same tiles in the same order.

With a mesh (``parallel.mesh``), every rank plans the same lists and
sweeps its round-robin share of each (``pruning.split_tiles_balanced``);
the partial counts merge by a SUM over the ranks, the NN keys by a MIN
after each pass, so every rank holds the whole result (the counterpart of
the JAX engine's ``_pops_dispatch_mesh`` and ``_nn_dispatch_mesh``).
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import pmin_, psum_
from ..utils import textio_native
from ..utils.logger import is_verbose, logger
from . import kernels, pruning
from .kernels import DEFAULT_COL_BLOCK, DEFAULT_ROW_BLOCK
from .pairwise import pair_d2

# the NN band pass: frames within +-4 column blocks of Morton positions
NN_BAND_BLOCKS = 4
NN_BAND_ORDER = "morton"


def resolve_device(device):
    """torch.device for ``device``; a CUDA device must exist (there is no
    silent CPU fallback). In an initialised process group a bare "cuda" is
    the rank's card, ``cuda:LOCAL_RANK % device_count`` (the rank when
    LOCAL_RANK is unset)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available")
    if device.index is None and dist.is_available() and dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


class DensityEngine:
    """Populations and nearest neighbours of one frame matrix on ``device``.

    Any (row_block, col_block) pair is served: N is padded to their least
    common multiple. Each stage sweeps bidirectionally when its switch is
    on and its grid allows it, else symmetrically (same results):

      populations: ``POPS_BIDIR``;
      nearest neighbours: ``NN_BIDIR`` and col_block % row_block == 0
      (the closure of the band and phase-2 masks works on that grid).

    The switches are the counterparts of the JAX engine's VMEM caps
    (``POPS_BIDIR_SCRATCH_CAP``, ``NN_BIDIR_SCRATCH_CAP``), which 0 turns
    off; the CUDA kernels fold through global atomics and have no such
    limit.

    With a ``mesh`` (``parallel.mesh.Mesh``) each rank sweeps its share of
    every tile list on ``device`` and the results merge over the ranks;
    ``last_stats`` then says ``mode`` "bidir-mesh" or "symmetric-mesh",
    with ``mesh_devices`` and this rank's ``per_device_tiles``."""

    POPS_BIDIR = True
    NN_BIDIR = True

    def __init__(self, coords, row_block=DEFAULT_ROW_BLOCK,
                 col_block=DEFAULT_COL_BLOCK, device="cuda", mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.row_block = row_block
        self.col_block = col_block
        self.coords = np.ascontiguousarray(coords, dtype=np.float32)
        self.n, self.d = self.coords.shape
        block = int(np.lcm(row_block, col_block))
        self.n_pad = -(-self.n // block) * block
        self._orders = {}   # name -> (order or None, padded host (N_pad, D))
        self._dev = {}      # cached device tensors
        self.last_stats = {}

    # -- cached layouts ------------------------------------------------------

    def _padded(self, name):
        """(order, padded) for layout ``name``: 'dim0' (stable sort by the
        first coordinate) or 'morton'; pads at 3e38."""
        if name not in self._orders:
            if name == "dim0":
                order = np.argsort(self.coords[:, 0], kind="stable")
            elif name == "morton":
                native = textio_native.morton_order_pad(self.coords,
                                                        n_pad=self.n_pad)
                if native is not None:
                    self._orders[name] = native
                    return native
                order = pruning.morton_order(self.coords)
            else:
                raise ValueError(name)
            padded = np.full((self.n_pad, self.d), np.float32(3e38),
                             dtype=np.float32)
            padded[:self.n] = self.coords[order]
            self._orders[name] = (order, padded)
        return self._orders[name]

    def _cached(self, key, make):
        if key not in self._dev:
            self._dev[key] = make()
        return self._dev[key]

    def _put(self, arr):
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    def _tiles(self, mask):
        """Flat (ti, tj) int32 tile list of a host or device mask, on the
        device, or None."""
        if isinstance(mask, torch.Tensor):
            return pruning.tile_list_device(mask)
        tiles = pruning.tile_list(mask)
        return None if tiles is None else tuple(map(self._put, tiles))

    def coords_t(self, name):
        """(D, N_pad) float32 frame matrix of layout ``name`` on device."""
        return self._cached(("ct", name),
                            lambda: self._put(self._padded(name)[1].T))

    def oid(self, name):
        """(N_pad,) int32 original ids of layout ``name`` (pads IMAX)."""
        def make():
            order, _ = self._padded(name)
            oid = np.full(self.n_pad, kernels.IMAX, dtype=np.int32)
            oid[:self.n] = order
            return self._put(oid)
        return self._cached(("oid", name), make)

    def d2b(self, name):
        """(nrb, ncb) bbox distance lower bounds of layout ``name``."""
        return self._cached(("d2b", name), lambda: pruning.bbox_d2(
            self.coords_t(name), self.row_block, self.col_block))

    def _best_sort(self, thresh2):
        """The layout (dim0 or morton) that prunes more tiles at this
        threshold; dim0 on ties. Both skip counts come back in one
        fetch."""
        skip = torch.stack([(self.d2b(name) > float(thresh2)).sum()
                            for name in ("dim0", "morton")]).tolist()
        return "morton" if skip[1] > skip[0] else "dim0"

    def _stats(self, bidir, plan):
        """A stage's ``last_stats`` start: its mode, planner and mesh."""
        mode = "bidir" if bidir else "symmetric"
        if self.mesh is None:
            return {"mode": mode, "plan": plan}
        return {"mode": mode + "-mesh", "plan": plan,
                "mesh_devices": self.mesh.size}

    def _share(self, tiles):
        """This rank's share of the per-tile tensors ``tiles``: all of
        them without a mesh."""
        if self.mesh is None:
            return tiles
        return pruning.split_tiles_balanced(tiles, self.mesh.rank,
                                            self.mesh.size)

    def _log_stats(self, stage, tiles):
        if is_verbose():
            frac = (tiles * float(self.row_block * self.col_block)
                    / (float(self.n) * self.n))
            logger(f"    [{stage}: {tiles} tiles computed = {frac:.1%} of"
                   " N^2 incl. padding]")

    # -- populations -----------------------------------------------------------

    def pops_plan(self, radii, bidir=True, stats=None):
        """Layout name, tile list and per-tile radius masks of a
        populations sweep: (name, ti, tj, rmask), int32 tensors on the
        device. The list is the active plane at the largest radius,
        restricted to the upper triangle and planned on the device when
        ``bidir``, else planned on the host. ``stats``, if given, receives
        ``t_best_sort``: the seconds spent choosing the layout (its frame
        order, upload, bbox matrix and skip counts)."""
        t0 = time.perf_counter()
        r_max2 = np.float32(max(radii)) * np.float32(max(radii))
        name = self._best_sort(r_max2)
        if stats is not None:
            stats["t_best_sort"] = time.perf_counter() - t0
        rb, cb = self.row_block, self.col_block
        thresh2s = [r_max2] + [np.float32(r) * np.float32(r) for r in radii]
        if bidir:
            planes = pruning.le_planes_device(self.d2b(name), thresh2s)
            tiles = pruning.tile_list_device(
                pruning.upper_tri_device(planes[0], rb, cb))
            if tiles is None:
                empty = torch.zeros(0, dtype=torch.int32, device=self.device)
                return name, empty, empty, empty
            return (name,) + tiles + (
                pruning.rmask_gather_device(planes[1:], *tiles),)
        planes = pruning.threshold_planes(self.d2b(name), thresh2s)
        tiles = pruning.tile_list(planes[0])
        if tiles is None:
            tiles = (np.zeros(0, np.int32),) * 2
        ti, tj = tiles
        rmask = np.zeros(len(ti), dtype=np.int32)
        for r_idx in range(len(radii)):
            rmask |= planes[1 + r_idx][ti, tj].astype(np.int32) << r_idx
        return (name,) + tuple(map(self._put, (ti, tj, rmask)))

    def populations(self, radii):
        """dict radius -> (N,) int64 populations (self included); the
        sweep's mode ("bidir" or "symmetric") and planner ("device" or
        "host") are in ``last_stats["populations"]``, with ``t_plan`` and
        the part of it that chose the layout, ``t_best_sort``."""
        t0 = time.perf_counter()
        radii = list(radii)
        bidir = self.POPS_BIDIR
        stats = self._stats(bidir, "device" if bidir else "host")
        name, ti, tj, rmask = self.pops_plan(radii, bidir, stats)
        radii2 = self._put(np.asarray(
            [np.float32(r) * np.float32(r) for r in radii], np.float32))
        stats["computed_tiles"] = int(len(ti))
        ti, tj, rmask = self._share((ti, tj, rmask))
        if self.mesh is not None:
            stats["per_device_tiles"] = int(len(ti))
        stats["t_plan"] = time.perf_counter() - t0
        self._log_stats("pops", stats["computed_tiles"])
        t0 = time.perf_counter()
        ct = self.coords_t(name)
        args = (radii2, self.n, ti, tj, rmask, self.row_block,
                self.col_block)
        if bidir:
            counts = kernels.pops_bidir(ct, *args)
        else:
            # the self pair (d2 = 0) counts in its diagonal tile, which
            # one rank sweeps
            counts = kernels.pops_sparse(ct, ct, *args)
        if self.mesh is not None:
            psum_(counts, self.mesh)
        counts = counts[:, :self.n]
        if bidir:
            counts = counts + 1  # each frame's self count, once
        counts = counts.cpu().numpy()
        stats["t_sweep"] = time.perf_counter() - t0
        self.last_stats["populations"] = stats
        order, _ = self._padded(name)
        unsorted = np.empty_like(counts)
        unsorted[:, order] = counts
        return {r: unsorted[i].astype(np.int64) for i, r in enumerate(radii)}

    # -- nearest neighbours ----------------------------------------------------

    def _fe_layout(self, fe, name):
        order, _ = self._padded(name)
        fe_pad = np.full(self.n_pad, np.inf, dtype=np.float32)
        fe_pad[:self.n] = fe[order]
        return self._put(fe_pad)

    def _nn_bidir_ok(self):
        return self.NN_BIDIR and self.col_block % self.row_block == 0

    def _nn_sweep(self, name, fe, tiles, keys, bidir, stats, stage):
        """Sweep ``tiles`` (device (ti, tj) or None) in layout ``name`` --
        an upper-triangular closure swept bidirectionally, or any mask's
        list swept row-side -- folding into the id-keyed ``keys``; on a
        mesh, this rank's share, then the keys' MIN over the ranks. Sets
        ``stats[stage + "_tiles"]`` to the list's length and, on a mesh,
        ``stats["per_device_tiles"][stage]`` to the share's (both stay 0
        without a list)."""
        if tiles is None:
            return
        stats[stage + "_tiles"] = len(tiles[0])
        ti, tj = self._share(tiles)
        if self.mesh is not None:
            stats["per_device_tiles"][stage] = len(ti)
        ct, fe_l, oid = (self.coords_t(name), self._fe_layout(fe, name),
                         self.oid(name))
        if bidir:
            kernels.nn_bidir(ct, fe_l, oid, self.n, ti, tj, keys,
                             self.row_block, self.col_block)
        else:
            kernels.nn_sparse(ct, fe_l, oid, ct, fe_l, oid, self.n, ti, tj,
                              keys, self.row_block, self.col_block)
        if self.mesh is not None:
            pmin_(keys, self.mesh)

    def nn_band_mask(self, bidir=True):
        """The band pass's tile mask and the mask it sweeps: on the device,
        the band and its upper-triangular closure, when ``bidir``; else
        the band on the host (numpy), twice."""
        rb, cb = self.row_block, self.col_block
        nrb, ncb = self.n_pad // rb, self.n_pad // cb
        if bidir:
            band = pruning.band_mask_device(nrb, ncb, rb, cb,
                                            NN_BAND_BLOCKS * cb, self.device)
            return band, pruning.bidir_closure_device(band, rb, cb)
        band = pruning.band_mask(nrb, ncb, rb, cb, NN_BAND_BLOCKS * cb)
        return band, band

    def nearest_neighbors(self, free_energy):
        """Joint NN / lower-fe NN search with two-phase exact pruning:

          1. a band pass over neighbouring positions of the
             ``NN_BAND_ORDER`` layout bounds both neighbour distances of
             every frame;
          2. the full pass, in whichever of the dim0 and morton layouts
             sweeps less, skips tiles whose bbox distance exceeds the row
             block's bound -- tiles holding the true minima always survive.

        Both passes fold into one buffer keyed by original frame id.
        Distance ties break toward the smaller original id, as in the
        reference's original-order scan. Returns (nh_idx, nh_d2,
        nhhd_idx, nhhd_d2) numpy arrays; absent neighbours are (0, 0.0).
        ``last_stats["nn"]`` holds the planner ("device" or "host") and
        three disjoint times: ``t_plan`` (building masks and tile lists),
        ``t_band`` (the band sweep and the order choice) and ``t_sweep``
        (phase 2's sweep and the readback); on a mesh, ``per_device_tiles``
        is this rank's share of each pass, {"band": .., "phase2": ..}."""
        fe = np.asarray(free_energy, dtype=np.float32)
        rb, cb = self.row_block, self.col_block
        nrb, ncb = self.n_pad // rb, self.n_pad // cb
        bidir = self._nn_bidir_ok()
        stats = self._stats(bidir, "device" if bidir else "host")
        stats.update(band_tiles=0, phase2_tiles=0, t_plan=0.0)
        if self.mesh is not None:
            stats["per_device_tiles"] = {"band": 0, "phase2": 0}

        def planned(fn, *args):
            t = time.perf_counter()
            out = fn(*args)
            stats["t_plan"] += time.perf_counter() - t
            return out

        t0 = time.perf_counter()
        keys = kernels.nn_keys_init(self.n_pad, self.device)
        if ncb > 2 * NN_BAND_BLOCKS:
            band, band_eff = planned(self.nn_band_mask, bidir)
            self._nn_sweep(NN_BAND_ORDER, fe, planned(self._tiles, band_eff),
                           keys, bidir, stats, "band")
            del band_eff
            # per-frame bound: the larger of the two band distances (on a
            # mesh, of the merged keys, so that every rank plans alike)
            d_band, _ = kernels.unpack_keys(keys[:, :self.n])
            ub_oid = d_band.amax(dim=0)
            names, acts = ("dim0", "morton"), []
            for name in names:
                oid = self.oid(name).long()
                ub = torch.full((self.n_pad,), float("inf"),
                                device=self.device)
                ub[:self.n] = ub_oid[oid[:self.n]]
                row_ub = ub.reshape(nrb, rb).amax(dim=1)
                act = self.d2b(name) <= row_ub[:, None]
                if not bidir:
                    act = act.cpu().numpy()
                if name == NN_BAND_ORDER:
                    act = act & ~band
                acts.append(act)
            del band
            work = [a.sum() for a in acts]
            work = (torch.stack(work).tolist() if bidir
                    else [int(w) for w in work])
            # the smaller work wins, dim0 on ties
            pick = 1 if work[1] < work[0] else 0
            name, active = names[pick], acts[pick]
            del acts
            stats["order"] = name
            stats["t_band"] = time.perf_counter() - t0 - stats["t_plan"]
        else:
            # too few column blocks for a band to prune anything
            name = NN_BAND_ORDER
            active = (torch.ones((nrb, ncb), dtype=torch.bool,
                                 device=self.device) if bidir
                      else np.ones((nrb, ncb), dtype=bool))
        t0, t_plan0 = time.perf_counter(), stats["t_plan"]
        if bidir:
            active = planned(pruning.bidir_closure_device, active, rb, cb)
        tiles = planned(self._tiles, active)
        del active
        self._nn_sweep(name, fe, tiles, keys, bidir, stats, "phase2")
        d2, ids = kernels.unpack_keys(keys[:, :self.n])
        absent = ~(d2 < float("inf"))
        ids = torch.where(absent, 0, ids)
        d2 = pair_d2(self._put(self.coords), ids)
        d2 = torch.where(absent, 0.0, d2)
        ids = ids.cpu().numpy()
        d2 = d2.cpu().numpy()
        stats["t_sweep"] = (time.perf_counter() - t0
                            - (stats["t_plan"] - t_plan0))
        stats["computed_tiles"] = stats["band_tiles"] + stats["phase2_tiles"]
        self.last_stats["nn"] = stats
        self._log_stats("nn", stats["computed_tiles"])
        return ids[0], d2[0], ids[1], d2[1]
