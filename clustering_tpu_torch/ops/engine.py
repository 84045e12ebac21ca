"""Device-resident driver for the density pipeline's O(N^2) stages.

Counterpart of ``clustering_tpu/ops/engine.py`` on its single-chip paths:
tile sweeps over bbox-pruned tile lists, either upper-triangular
(bidirectional kernels: each unordered pair evaluated once, serving both
frames) or symmetric (row-side kernels over both orientations). The
frames are uploaded once; each layout's order is sorted, and its frame
matrix gathered, on the device; the bbox distances are computed on the
device and thresholded there. Every stage keeps its masks and tile
lists on the device (``pruning.*_device``) on both routes: the route
decides only whether the plane is restricted to the upper triangle (or
closed, ``bidir_closure_device``) and which kernel sweeps the list.

With a mesh (``parallel.mesh``), the row blocks are dealt over the mesh's
devices (``row_deals``: device g of S owns blocks g, g + S, ...), and
each device plans the bounds, planes and tile list of its own rows on
copies of its own of the layout, then sweeps that list; the partial
counts merge by a SUM, the NN keys by a MIN after each pass (the
counterpart of the JAX engine's ``_pops_dispatch_mesh`` and
``_nn_dispatch_mesh``). The one choice that reads every row, the
layout with more skipped tiles, sums the devices' counts; a
bidirectional closure ORs the devices' column-block groups
(``pruning.group_rows_device``). This process plans and launches each
of its devices' rows, then merges the partials on its primary device;
on a process group's mesh every rank does so for its own devices (one or
several, by global device index) and adds an ``all_reduce`` of its
merged part. Either way the caller holds the whole result, bit for bit
one device's. Without a mesh the engine runs the same code over one
device, which plans every row.
"""

import contextlib
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import LocalMesh, Mesh, planning, rank_devices, skew
from ..utils import textio_native
from ..utils.logger import is_verbose, logger
from ..utils.timer import adopt, count, current, span
from . import kernels, pruning
from .kernels import DEFAULT_COL_BLOCK, DEFAULT_ROW_BLOCK
from .pairwise import pair_d2

# the NN band pass: frames within +-4 column blocks of Morton positions
NN_BAND_BLOCKS = 4
NN_BAND_ORDER = "morton"


def resolve_device(device):
    """torch.device for ``device`` (None: "cuda"); a CUDA device must exist
    (there is no silent CPU fallback). In an initialised process group a
    bare "cuda" is the rank's primary card by the host rule
    (``parallel.mesh.rank_devices``: ``cuda:0`` for a rank alone on its
    host, else ``cuda:local_index % device_count``, never one card for two
    ranks of a host); that is a collective unless the launcher set
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available")
    if device.index is None and dist.is_available() and dist.is_initialized():
        device = rank_devices("cuda")[0]
    return device


def engine_device(device, mesh):
    """An engine's device: ``device`` resolved (:func:`resolve_device`;
    None: "cuda"), or on a mesh the mesh's primary device, which
    ``device`` may name but not contradict (another type or card raises
    ValueError)."""
    if mesh is None:
        return resolve_device(device)
    if device is None:
        return mesh.device
    want, have = torch.device(device), mesh.device
    if want.type != have.type or want.index not in (None, have.index):
        raise ValueError(f"device={str(device)!r} is not the mesh's device"
                         f" {have}")
    return have


def per_device_tiles(mesh, counts):
    """``last_stats``' ``per_device_tiles`` of the share sizes ``counts``
    (one per device this process sweeps on): the list, but this rank's
    count alone on a group's mesh of one device per rank."""
    one = isinstance(mesh, Mesh) and len(counts) == 1
    return counts[0] if one else counts


def resolve_backend(backend, dense=False, mesh=None):
    """The route of the JAX package's ``backend`` argument: False for the
    tile-sweep route ("auto" and "pallas": the kernels on CUDA, their
    plain versions on the CPU), True for the dense plain versions ("xla",
    where ``dense`` allows it: the ops functions, not the engines, and on
    one device, without ``mesh``). Anything else raises ValueError."""
    if backend in ("auto", "pallas"):
        return False
    if backend == "xla" and dense:
        if mesh is not None:
            raise ValueError('backend="xla" runs on one device: mesh='
                             ' needs backend="pallas"')
        return True
    raise ValueError(
        f"backend={backend!r} is not served here: the port runs the JAX"
        " package's backend=\"pallas\" route (its CUDA kernels, or their"
        " plain versions on the CPU); choose the device with device=")


def warm_on(device, mesh):
    """Whether the warms (``precompile_*``) run: on a CUDA device without a
    mesh (from a worker thread, uploads could race the collectives)."""
    return device.type == "cuda" and mesh is None


def warm_failed(what, exc):
    """Report a warm's failure under -v when
    CLUSTERING_TPU_PROFILE_SUBSTAGES is set: a warm never raises, and the
    stage it warms raises the failure itself if it recurs there."""
    if os.environ.get("CLUSTERING_TPU_PROFILE_SUBSTAGES"):
        logger(f"      [{what} failed: {exc!r}]")


def _band_nh_mean(keys):
    """fp32 mean of the finite per-frame nh bounds in a band pass's (2,
    N_pad) key buffer (the JAX engine's ``_band_nh_mean``): an estimate of
    ``compute_sigma2``, exact for every frame whose nearest neighbour lies
    within the band. A 0-d device tensor."""
    v, _ = kernels.unpack_keys(keys[0])
    ok = torch.isfinite(v)
    total = torch.where(ok, v, torch.zeros_like(v)).sum()
    return total / ok.sum().to(torch.float32).clamp_min(1.0)


# -- ub-quantile tiers of the NN phase 2 (the JAX engine's helpers) ----------

def _ub_tiers(stacked_d, n, qs):
    """Per-frame tier from the band pass's (2, N_pad) [nh; hd] distances,
    entries below ``n`` real: tier k holds the frames whose bound ub =
    max(nh, hd) lies in (tau_{k-1}, tau_k], frames above the last tau or
    without a band neighbour the last tier. The taus approach the ``qs``
    quantiles of the finite bounds by 24 rounds of fp32 bisection, each
    the upper end of its bracket. Any non-decreasing taus keep phase 2
    exact (a row block's bound, its largest tier's tau, dominates every
    member's ub); the quantiles only balance the tiers. Returns (tier
    int64 (N_pad,), taus float32 (len(qs),)), the JAX engine's bit for
    bit."""
    ub = torch.maximum(stacked_d[0], stacked_d[1])
    dev = ub.device
    real = (torch.arange(ub.shape[0], device=dev) < n) & torch.isfinite(ub)
    inf = torch.tensor(float("inf"), device=dev)
    vals = torch.where(real, ub, inf)
    m = real.sum().to(torch.float32)
    # all bounds infinite: finite taus, every frame in the last tier
    zero = torch.zeros((), device=dev)
    lo = torch.where(m > 0, vals.min(), zero)
    hi = torch.where(m > 0, torch.where(real, ub, -inf).max(), zero)
    q = torch.tensor(qs, dtype=torch.float32, device=dev)
    target = q * torch.clamp(m - 1.0, min=0.0) + 1.0
    los, his = lo.repeat(len(qs)), hi.repeat(len(qs))
    for _ in range(24):
        mid = (los + his) * 0.5
        cnt = (vals[None, :] <= mid[:, None]).sum(dim=1).to(torch.float32)
        go_hi = cnt < target
        los = torch.where(go_hi, mid, los)
        his = torch.where(go_hi, his, mid)
    return torch.searchsorted(his, ub, side="left"), his


def _tier_sort_perm(tier, oid_w, n, n_tiers):
    """The tier of each position of a layout whose original ids are
    ``oid_w`` (pads: ``n_tiers``), and its stable argsort: the (tier,
    position) order, pads last."""
    real = torch.arange(oid_w.shape[0], device=oid_w.device) < n
    tier_w = torch.where(real, tier[torch.where(real, oid_w.long(), 0)],
                         n_tiers)
    return tier_w, torch.argsort(tier_w, stable=True)


def _tiered_rows(coords_t, fe_w, oid_w, tier_w, taus, perm, row_block,
                 n_tiers):
    """Rows re-sorted by ``perm`` and each row block's bound: the tau of
    its largest tier (+inf for the last), none for a block of pads."""
    tiers_p = tier_w[perm].reshape(-1, row_block)
    bounds = torch.cat([taus, taus.new_full((1,), float("inf"))])
    bound = bounds[tiers_p.amax(dim=1).clamp(max=n_tiers - 1)]
    bound = torch.where(tiers_p.amin(dim=1) < n_tiers, bound,
                        bound.new_full((), float("-inf")))
    return (coords_t[:, perm].contiguous(), fe_w[perm].contiguous(),
            oid_w[perm].contiguous(), bound)


def _tier_active(rows_t, bound, row_block, col_block, rows=None):
    """The bidirectional tiered phase 2's active mask for the row blocks of
    the deal ``rows`` (None: all): bbox distance within the row block's
    ``bound``, in the layout ``rows_t`` of :func:`_tiered_rows` (every
    frame re-sorted by (tier, position), rows and columns alike, so that
    the upper-triangular sweep composes with the tier bounds); the caller
    closes it (``bidir_closure``)."""
    return pruning.le_rows_device(
        pruning.bbox_d2(rows_t, row_block, col_block, rows=rows),
        pruning.dealt(bound, rows).to(rows_t.device))


def _tiered_layout(coords_t, fe_w, oid_w, tier_w, taus, perm, row_block,
                   col_block, n_tiers):
    """The row-side tiered phase 2's layout: rows re-sorted by (tier,
    position) against the columns of the layout ``coords_t``. Returns the
    permuted rows' (coords_t, fe, oid) and the active mask on the
    device."""
    rows_t, fe_r, oid_r, bound = _tiered_rows(
        coords_t, fe_w, oid_w, tier_w, taus, perm, row_block, n_tiers)
    d2b = pruning.bbox_d2(rows_t, row_block, col_block, cols_t=coords_t)
    return rows_t, fe_r, oid_r, d2b <= bound[:, None]


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

    Nearest neighbours sweep phase 2 ub-quantile tiered or block-bound
    (``nearest_neighbors(tier_qs=...)``), and may start from a band pass
    that ``populations(nn_band_radius=...)`` began.

    ``backend`` is the JAX engine's: "auto" and "pallas" select the
    tile-sweep route, which is the only one; anything else raises
    ValueError. The device is ``device`` (default "cuda", or the mesh's).

    With a ``mesh`` (``parallel.make_mesh``: a local mesh or a process
    group's) each device sweeps its share of every tile list and the
    results merge on the mesh's primary device, which is the engine's
    (``device`` may name it); ``last_stats`` then says ``mode`` (NN:
    ``route``) "bidir-mesh" or "symmetric-mesh", with ``mesh_devices`` and
    the shares' sizes, ``per_device_tiles`` (:func:`per_device_tiles`)."""

    POPS_BIDIR = True
    NN_BIDIR = True
    # set on the warms' scratch engines (_scratch): no -v lines
    _quiet = False

    def __init__(self, coords, row_block=DEFAULT_ROW_BLOCK,
                 col_block=DEFAULT_COL_BLOCK, backend="auto", mesh=None,
                 device=None):
        resolve_backend(backend)
        self.device = engine_device(device, mesh)
        self.mesh = mesh
        # the devices the sweeps run on: one without a mesh
        self._spread = LocalMesh((self.device,)) if mesh is None else mesh
        # each device and the row blocks it plans (None: all of them)
        self._deals = ([(self.device, None)] if mesh is None
                       else mesh.row_deals())
        self.row_block = row_block
        self.col_block = col_block
        self.coords = np.ascontiguousarray(coords, dtype=np.float32)
        self.n, self.d = self.coords.shape
        block = int(np.lcm(row_block, col_block))
        self.n_pad = -(-self.n // block) * block
        self._orders = {}   # name -> host frame order of a built layout
        self._dev = {}      # cached device tensors
        self.last_stats = {}
        # the NN band pass started by populations(nn_band_radius=...)
        self._band_prefetch = None
        self._band_prefetch_error = None
        self._band_prefetch_thread = None

    # -- cached layouts ------------------------------------------------------

    def _layout(self, name):
        """The host frame order of layout ``name`` ((N,) int64: position
        -> original id): 'orig' (the frames as given), 'dim0' (stable sort
        by the first coordinate) or 'morton'; the layout is built on the
        device once (:meth:`_build_layouts`)."""
        self._build_layouts((name,))
        return self._orders[name]

    def layout_order(self, name):
        """The frame order of layout ``name`` if it is built, else None;
        builds nothing (the layouts are built on the stages' thread)."""
        return self._orders.get(name)

    def _build_layouts(self, names):
        """Build the layouts of ``names`` that are not built yet, on the
        engine's device from one upload of the frames (a
        ``layout.upload.frames`` span): each one's frame order, sorted there
        and downloaded once (a ``layout.sort.<name>`` span, its counter
        ``on_device`` 1 on a CUDA device), then its (D, N_pad) float32
        frame matrix (pads 3e38) gathered there (a ``layout.upload.<name>``
        span). The upload, the keys and the sort buffers are freed on
        return."""
        names = [name for name in names if name not in self._orders]
        if not names:
            return
        with span("layout.upload.frames"):
            frames = self._put(self.coords)
        sort = {"orig": lambda f: torch.arange(self.n, device=f.device),
                "dim0": pruning.dim0_order_device,
                "morton": pruning.morton_order_device}
        for name in names:
            if name not in sort:
                raise ValueError(name)
            with span("layout.sort." + name, on_device=int(frames.is_cuda)):
                order = sort[name](frames)
                order_host = order.cpu().numpy()
            with span("layout.upload." + name):
                coords_t = torch.full((self.d, self.n_pad), 3e38,
                                      dtype=torch.float32, device=self.device)
                for k in range(self.d):
                    torch.index_select(frames[:, k], 0, order,
                                       out=coords_t[k, :self.n])
            del order  # before the next layout's sort
            self._dev[("ct", name)] = coords_t
            self._orders[name] = order_host

    def _cached(self, key, make):
        if key not in self._dev:
            self._dev[key] = make()
        return self._dev[key]

    def _put(self, arr):
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    def coords_t(self, name):
        """(D, N_pad) float32 frame matrix of layout ``name`` on device
        (pads 3e38)."""
        self._build_layouts((name,))
        return self._dev[("ct", name)]

    def oid(self, name):
        """(N_pad,) int32 original ids of layout ``name`` (pads IMAX), put
        on the device at first use: built with the layout, the ids would
        lie beside the bbox matrices at the peak of ``populations.plan``."""
        def make():
            oid = np.full(self.n_pad, kernels.IMAX, dtype=np.int32)
            oid[:self.n] = self._layout(name)
            return self._put(oid)
        return self._cached(("oid", name), make)

    def _layout_copies(self, fn, name):
        """``fn(name)`` (:meth:`coords_t`, :meth:`oid`) for each device of
        the mesh, each device's its own; cached."""
        return self._cached((fn.__name__ + "*", name),
                            lambda: self._spread.copies(fn(name)))

    def d2b(self, name, part=0):
        """(rows, ncb) bbox distance lower bounds of layout ``name`` for the
        row blocks of deal ``part`` (without a mesh: all, (nrb, ncb)), on
        its device. The deals' matrices are built together, each from its
        device's copy of the layout, in a ``layout.bbox.<name>`` span."""
        def make():
            cts = ([self.coords_t(name)] if self.mesh is None
                   else self._layout_copies(self.coords_t, name))
            with span("layout.bbox." + name):
                return [pruning.bbox_d2(ct, self.row_block, self.col_block,
                                        rows=rows)
                        for ct, (_, rows) in zip(cts, self._deals)]
        return self._cached(("d2b", name), make)[part]

    def _total(self, values):
        """The sum of device tensors of one shape, one per deal, on the
        engine's device, over every rank of a group's mesh (the tensor
        itself without a mesh)."""
        out = values[0]
        for v in values[1:]:
            out = out + v.to(self.device)
        return self._spread.sum_ranks(out)

    def _dealt(self, t, part):
        """The entries of the per-row-block tensor ``t`` (on the engine's
        device) that deal ``part`` holds, on its device."""
        dev, rows = self._deals[part]
        return pruning.dealt(t, rows).to(dev)

    def _parts(self):
        return range(len(self._deals))

    def _best_sort(self, thresh2):
        """The layout (dim0 or morton) that prunes more tiles at this
        threshold; dim0 on ties. Both layouts are built from one upload;
        the skip counts, summed over the deals, come back in one fetch."""
        self._build_layouts(("dim0", "morton"))
        with planning(self.mesh):
            skip = self._total([torch.stack([
                (self.d2b(name, k) > float(thresh2)).sum()
                for name in ("dim0", "morton")])
                for k in self._parts()]).tolist()
        return "morton" if skip[1] > skip[0] else "dim0"

    def _closures(self, actives):
        """:func:`pruning.bidir_closure_device` of the mask whose deals are
        ``actives`` (one per deal, each on its device): without a mesh the
        closure of the whole; on a mesh each deal's rows closed on its
        device, from the sum of every deal's column-block groups."""
        rb, cb = self.row_block, self.col_block
        if self.mesh is None:
            # one device keeps the whole mask's closure, op for op: the
            # deals' gather of the mirror would add a (nrb, ncb) plane
            return [pruning.bidir_closure_device(actives[0], rb, cb)]
        groups = self._spread.copies(self._spread.sum([
            pruning.group_rows_device(a, rows, rb, cb)
            for a, (_, rows) in zip(actives, self._deals)]) > 0)
        return [pruning.closure_rows_device(a, g, rows, rb, cb)
                for a, g, (_, rows) in zip(actives, groups, self._deals)]

    def _tile_lists(self, actives):
        """Each deal's tile list of its mask (``pruning.tile_list_device``
        with global row blocks), or None."""
        return [pruning.tile_list_device(a, rows)
                for a, (_, rows) in zip(actives, self._deals)]

    def _stats(self, bidir, key="mode"):
        """A stage's ``last_stats`` start: its route under ``key``, its
        planner (the device, on every route) and mesh."""
        route = "bidir" if bidir else "symmetric"
        if self.mesh is None:
            return {key: route, "plan": "device"}
        return {key: route + "-mesh", "plan": "device",
                "mesh_devices": self.mesh.size}

    def _share_stats(self, counts, everyone, stats, stage=None):
        """On a mesh: the deals' tile counts ``counts`` to
        ``stats["per_device_tiles"]`` (``[stage]`` if given), and the most
        tiles one device of the mesh sweeps over their mean (``everyone``:
        every device's count, ``all_counts``) to the innermost open span's
        ``tiles_max_over_mean``."""
        if self.mesh is None:
            return
        shares = per_device_tiles(self.mesh, counts)
        if stage is None:
            stats["per_device_tiles"] = shares
        else:
            stats["per_device_tiles"][stage] = shares
        ratio = skew(everyone)
        if ratio is not None:
            count("tiles_max_over_mean", ratio)

    def _tile_counts(self, lists):
        """(each deal's tiles, every device's tiles over the mesh's ranks)
        of the lists (or None) of this process's deals: the second is what
        every rank decides on alike."""
        counts = [0 if t is None else len(t[0]) for t in lists]
        return counts, self._spread.all_counts(counts)

    def _log_stats(self, stage, tiles, what=""):
        if is_verbose() and not self._quiet:
            frac = (tiles * float(self.row_block * self.col_block)
                    / (float(self.n) * self.n))
            logger(f"    [{stage}: {tiles} tiles computed = {frac:.1%} of"
                   f" N^2 incl. padding{what}]")

    # -- populations -----------------------------------------------------------

    def pops_plan(self, radii, bidir=True, stats=None):
        """Layout name, tile list and per-tile radius masks of a
        populations sweep: (name, ti, tj, rmask), int32 tensors on the
        device, of the first deal (every row without a mesh;
        :meth:`_pops_plans` gives each deal's). The list is the active
        plane at the largest radius, restricted to the upper triangle when
        ``bidir``, planned on the device either way. ``stats``, if given,
        receives ``t_best_sort``: the seconds spent choosing the layout
        (its frame order, upload, bbox matrix and skip counts), the
        ``populations.best_sort`` span's; and ``mask_bits``, the bits set
        in the masks (the (tile, radius) pairs swept) as a tensor on the
        device, with the ``populations.radius_masks`` span under
        ``radius_masks``, which :meth:`populations` counts it on once its
        download has drained the stream."""
        name, plans = self._pops_plans(radii, bidir, stats)
        return (name,) + plans[0]

    def _pops_plans(self, radii, bidir, stats):
        """(name, [(ti, tj, rmask) of each deal, on its device]): the plan
        of :meth:`pops_plan` for every deal."""
        r_max2 = np.float32(max(radii)) * np.float32(max(radii))
        with span("populations.best_sort") as best:
            name = self._best_sort(r_max2)
        if stats is not None:
            stats["t_best_sort"] = best.seconds
        thresh2s = [r_max2] + [np.float32(r) * np.float32(r) for r in radii]
        # the k + 1 threshold planes, the largest radius's tile list (its
        # count is the plan's host sync) and the masks gathered from it
        with span("populations.radius_masks", radii=len(radii)) as masks, \
                planning(self.mesh):
            plans = [self._pops_deal(name, thresh2s, bidir, k)
                     for k in self._parts()]
        if stats is not None:
            stats["mask_bits"] = self._total([
                pruning.mask_bits(p[2], len(radii)) for p in plans])
            stats["radius_masks"] = masks
        return name, plans

    def _pops_deal(self, name, thresh2s, bidir, part):
        """(ti, tj, rmask) of deal ``part`` (:meth:`_pops_plans`)."""
        rb, cb = self.row_block, self.col_block
        dev, rows = self._deals[part]
        planes = pruning.le_planes_device(self.d2b(name, part), thresh2s)
        # the upper-triangle plane is a temporary: it must not stay
        # alive through the gather (0.19 GB at 10^7 frames)
        tiles = pruning.tile_list_device(
            pruning.upper_tri_device(planes[0], rb, cb, rows) if bidir
            else planes[0], rows)
        if tiles is None:
            ti = tj = rmask = torch.zeros(0, dtype=torch.int32, device=dev)
        else:
            ti, tj = tiles
            rmask = pruning.rmask_gather_device(
                planes[1:], pruning.local_rows(ti, rows), tj)
        return ti, tj, rmask

    def _all_tiles(self, n_radii):
        """Every tile of each deal's rows, each with all ``n_radii`` radii
        on: the unpruned plan, [(ti, tj, rmask)]."""
        plans = []
        for dev, rows in self._deals:
            ti, tj = pruning.tile_list_device(torch.ones(
                (pruning.deal_rows(self.n_pad // self.row_block, rows),
                 self.n_pad // self.col_block), dtype=torch.bool,
                device=dev), rows)
            plans.append((ti, tj, torch.full_like(ti, (1 << n_radii) - 1)))
        return plans

    def populations(self, radii, prune=True, nn_band_radius=None):
        """dict radius -> (N,) int64 populations (self included); the
        sweep's mode ("bidir" or "symmetric") and planner ("device") are
        in ``last_stats["populations"]``, with ``t_plan`` and
        the part of it that chose the layout, ``t_best_sort``, the layout
        it swept, ``order`` ("dim0", "morton"; "orig" unpruned), and the
        host finish, ``finish`` ("native" or "numpy") and ``t_finish``
        (:meth:`_pops_finish`); a pruned sweep adds ``mask_bits``, the
        (tile, radius) pairs that its radius masks admit, which the
        ``populations.radius_masks`` span counts.

        ``prune=False`` sweeps the JAX engine's unpruned plan: the frames
        in their given order ("orig"), every tile, row-side
        (``kernels.pops_sparse``).

        ``nn_band_radius``, one of ``radii``, starts the NN band pass from
        that radius's counts before returning (without a mesh), so that it
        runs while the caller unsorts and writes the counts; the next
        :meth:`nearest_neighbors` takes it if its free energies are those
        of these counts (``ops.density.free_energies``), bit for bit
        (``last_stats["populations"]["nn_band_prefetch"]``).

        The times are the spans': ``t_plan`` the ``populations.plan``
        span's (``t_best_sort`` its child ``populations.best_sort``),
        ``t_sweep`` ``populations.sweep`` and ``populations.download``
        together, ``t_finish`` ``populations.finish``."""
        radii = list(radii)
        bidir = prune and self.POPS_BIDIR
        stats = self._stats(bidir)
        with span("populations.plan") as plan:
            if prune:
                name, plans = self._pops_plans(radii, bidir, stats)
            else:
                name = "orig"
                with planning(self.mesh):
                    plans = self._all_tiles(len(radii))
            stats["order"] = name
            radii2 = self._put(np.asarray(
                [np.float32(r) * np.float32(r) for r in radii], np.float32))
            deal_tiles, everyone = self._tile_counts(plans)
            stats["computed_tiles"] = sum(everyone)
        stats["t_plan"] = plan.seconds
        self._log_stats("pops", stats["computed_tiles"])
        with span("populations.sweep", radii=len(radii)) as sweep:
            self._share_stats(deal_tiles, everyone, stats)
            parts = []
            for ct, r2, share in zip(
                    self._layout_copies(self.coords_t, name),
                    self._spread.copies(radii2), plans):
                args = (r2, self.n) + share + (self.row_block,
                                               self.col_block)
                if bidir:
                    parts.append(kernels.pops_bidir(ct, *args))
                else:
                    # the self pair (d2 = 0) counts in its diagonal tile,
                    # which one device sweeps
                    parts.append(kernels.pops_sparse(ct, ct, *args))
            counts = self._spread.sum(parts)
            if bidir:
                counts = counts + 1  # each frame's self count, once
            counts_band = None
            if (nn_band_radius is not None and nn_band_radius in radii
                    and self.mesh is None
                    and self.n_pad // self.col_block > 2 * NN_BAND_BLOCKS):
                counts_band = self._relayout(
                    counts[radii.index(nn_band_radius), :self.n], name,
                    NN_BAND_ORDER)
        with span("populations.download") as download:
            counts = counts.cpu().numpy()
        masks = stats.pop("radius_masks", None)
        if masks is not None:
            # the stream has drained: no wait of its own
            stats["mask_bits"] = masks.counters["mask_bits"] = int(
                stats["mask_bits"])
        sweep.settle()  # the kernels' step counts, drained too
        if counts_band is not None:
            self._start_band_prefetch(counts_band)
            stats["nn_band_prefetch"] = True
        stats["t_sweep"] = sweep.seconds + download.seconds
        with span("populations.finish") as finish:
            out, stats["finish"] = self._pops_finish(
                counts, self._layout(name), radii)
        stats["t_finish"] = finish.seconds
        self.last_stats["populations"] = stats
        return out

    def _pops_finish(self, counts_padded, order, radii):
        """Host postlude of a populations sweep (the JAX engine's
        ``_pops_finish``): scatter-unsort the padded (R, N_pad) int32
        download to original frame positions (``order``: layout position
        -> original id) and widen it to int64, in one native pass when the
        library loads, else by a numpy scatter and a cast per radius (the
        same arrays). Returns ({radius: (N,) int64}, "native" or
        "numpy")."""
        res = textio_native.pops_finish(counts_padded, self.n, order)
        if res is not None:
            return {r: res[i] for i, r in enumerate(radii)}, "native"
        counts = counts_padded[:, :self.n]
        unsorted = np.empty_like(counts)
        unsorted[:, order] = counts
        return ({r: unsorted[i].astype(np.int64)
                 for i, r in enumerate(radii)}, "numpy")

    # -- nearest neighbours ----------------------------------------------------

    # the tiered phase 2 (the JAX engine's constants): "auto" plans it from
    # TIERED_MIN_FRAMES frames when a typical 3.5x cut of the block-bound
    # list would save more than TIERED_MIN_SAVED_PAIRS pairs, and takes it
    # when the planned list does
    TIERED_MIN_SAVED_PAIRS = 6.0e10
    TIERED_MIN_FRAMES = 1 << 19
    TIER_QS_DEFAULT = (0.5, 0.9, 0.99)

    def _fe_layout(self, fe, name):
        order = self._layout(name)
        fe_pad = np.full(self.n_pad, np.inf, dtype=np.float32)
        fe_pad[:self.n] = fe[order]
        return self._put(fe_pad)

    def _nn_bidir_ok(self):
        return self.NN_BIDIR and self.col_block % self.row_block == 0

    def _planned(self, stats, fn, *args):
        """``fn(*args)`` in an ``nn.plan`` span (and on a mesh its
        ``mesh.plan``), whose seconds are added to ``stats["t_plan"]``."""
        with span("nn.plan") as plan, planning(self.mesh):
            out = fn(*args)
        stats["t_plan"] += plan.seconds
        return out

    def _nn_sweep(self, rows, tiles, keys, bidir, stats, stage, cols=None):
        """Sweep ``tiles`` (each deal's device (ti, tj) or None) -- an
        upper-triangular closure swept bidirectionally, or any mask's list
        swept row-side -- folding into the id-keyed ``keys``; ``rows`` and
        ``cols`` hold the (coords_t, fe, oid) tensors of the rows and the
        columns for each device (``cols`` None: the rows'). Each device
        folds its deal's list into a copy of ``keys`` of its own, all taken
        before the first launch, and the copies merge into ``keys`` by a
        MIN. Sets ``stats[stage + "_tiles"]`` to the lists' length, which
        the enclosing span counts under the same name, and, on a mesh,
        ``stats["per_device_tiles"][stage]`` to the deals' (both stay 0
        without a tile)."""
        counts, everyone = self._tile_counts(tiles)
        if not sum(everyone):
            return
        stats[stage + "_tiles"] = sum(everyone)
        count(stage + "_tiles", sum(everyone))
        self._share_stats(counts, everyone, stats, stage)
        parts = self._spread.copies(keys)
        for k, ((dev, _), t) in enumerate(zip(self._deals, tiles)):
            ti, tj = t or (torch.zeros(0, dtype=torch.int32, device=dev),) * 2
            if bidir:
                kernels.nn_bidir(*rows[k], self.n, ti, tj, parts[k],
                                 self.row_block, self.col_block)
            else:
                kernels.nn_sparse(*rows[k], *(cols or rows)[k], self.n, ti,
                                  tj, parts[k], self.row_block,
                                  self.col_block)
        self._spread.min(parts)

    def _nn_rows(self, name, fe_l):
        """(coords_t, fe, oid) of layout ``name`` for each device; ``fe_l``
        is its fe on the engine's device."""
        return list(zip(self._layout_copies(self.coords_t, name),
                        self._spread.copies(fe_l),
                        self._layout_copies(self.oid, name)))

    def _row_copies(self, rows):
        """The (coords_t, fe, oid) tensors ``rows`` for each device."""
        return list(zip(*(self._spread.copies(t) for t in rows)))

    def nn_band_mask(self, bidir=True, band_blocks=NN_BAND_BLOCKS):
        """The band pass's tile mask and the mask it sweeps, on the device:
        the band and, when ``bidir``, its upper-triangular closure, else
        the band itself; of the first deal (every row without a mesh;
        :meth:`_nn_band_masks` gives each deal's)."""
        bands, swept = self._nn_band_masks(bidir, band_blocks)
        return bands[0], swept[0]

    def _nn_band_masks(self, bidir, band_blocks):
        """(bands, swept): :meth:`nn_band_mask` of each deal, on its
        device."""
        rb, cb = self.row_block, self.col_block
        bands = [pruning.band_mask_device(self.n_pad // rb, self.n_pad // cb,
                                          rb, cb, band_blocks * cb, dev,
                                          rows)
                 for dev, rows in self._deals]
        return bands, self._closures(bands) if bidir else bands

    def _nn_band(self, fe_l, order_name, band_blocks, bidir, stats):
        """Phase 1: the band pass in layout ``order_name`` (``fe_l``: its
        fe on the device), then, from each frame's bound (the larger of its
        two band distances; on a mesh, of the merged keys, so that every
        rank plans alike), both orders' phase-2 activity masks, the band's
        tiles taken out of its own order's. Returns {"keys": the key buffer
        after the band pass, "acts": the (dim0, morton) masks, "work":
        their active counts}, all on the device (no host sync but the
        band list's count). Fills ``stats``' band_tiles and t_plan (its
        ``nn.plan`` spans)."""
        rb = self.row_block
        nrb = self.n_pad // rb
        keys = kernels.nn_keys_init(self.n_pad, self.device)
        bands, band_eff = self._planned(stats, self._nn_band_masks, bidir,
                                        band_blocks)
        self._nn_sweep(self._nn_rows(order_name, fe_l),
                       self._planned(stats, self._tile_lists, band_eff),
                       keys, bidir, stats, "band")
        del band_eff
        d_band, _ = kernels.unpack_keys(keys[:, :self.n])
        ub_oid = d_band.amax(dim=0)
        acts = []
        for name in ("dim0", "morton"):
            oid = self.oid(name).long()
            ub = torch.full((self.n_pad,), float("inf"), device=self.device)
            ub[:self.n] = ub_oid[oid[:self.n]]
            row_ub = ub.reshape(nrb, rb).amax(dim=1)
            with planning(self.mesh):
                act = [pruning.le_rows_device(self.d2b(name, k),
                                              self._dealt(row_ub, k))
                       for k in self._parts()]
                if name == order_name:
                    act = [a & ~b for a, b in zip(act, bands)]
            acts.append(act)
        work = torch.stack([self._total([a.sum() for a in act])
                            for act in acts])
        return {"keys": keys, "acts": acts, "work": work}

    # -- the band prefetch -----------------------------------------------------

    def _relayout(self, values, src, dst):
        """(N,) ``values`` at the frame positions of layout ``src``,
        gathered to those of ``dst``, on the device."""
        by_id = torch.empty_like(values)
        by_id[self.oid(src)[:self.n].long()] = values
        return by_id[self.oid(dst)[:self.n].long()]

    def _start_band_prefetch(self, counts_band):
        """Start the NN band pass from the (N,) device counts
        ``counts_band`` in the band order: on a thread, download them,
        compute free energies exactly as ``ops.density.free_energies``
        does (on the host: a 1-ulp difference of a device log would make
        every consumer miss), and enqueue phase 1 (:meth:`_nn_band`). The
        stash, or the exception that ended the thread, waits for
        :meth:`_take_band_prefetch`. The thread, "band-prefetch", runs
        in an ``nn.band_prefetch`` span whose parent is the span open
        here."""
        from .density import free_energies
        self._take_band_prefetch()  # an unconsumed earlier one is dropped
        bidir = self._nn_bidir_ok()
        parent = current()

        def work():
            try:
                with adopt(parent), span("nn.band_prefetch"):
                    fe_band = free_energies(counts_band.cpu().numpy())
                    fe_pad = np.full(self.n_pad, np.inf, dtype=np.float32)
                    fe_pad[:self.n] = fe_band
                    stats = {"band_tiles": 0, "t_plan": 0.0}
                    band = self._nn_band(self._put(fe_pad), NN_BAND_ORDER,
                                         NN_BAND_BLOCKS, bidir, stats)
                    band.update(fe_band=fe_band, order_name=NN_BAND_ORDER,
                                band_blocks=NN_BAND_BLOCKS, bidir=bidir,
                                band_tiles=stats["band_tiles"],
                                nh_mean=_band_nh_mean(band["keys"]))
                self._band_prefetch = band
            except Exception as exc:  # raised by _take_band_prefetch
                self._band_prefetch_error = exc

        self._band_prefetch_thread = threading.Thread(
            target=work, name="band-prefetch", daemon=True)
        self._band_prefetch_thread.start()

    def _take_band_prefetch(self):
        """Join the band prefetch's thread and take its stash (None if there
        is none); an exception that ended the thread is raised here."""
        if self._band_prefetch_thread is not None:
            self._band_prefetch_thread.join()
            self._band_prefetch_thread = None
        pf, self._band_prefetch = self._band_prefetch, None
        err, self._band_prefetch_error = self._band_prefetch_error, None
        if err is not None:
            raise err
        return pf

    def band_sigma2_estimate(self, timeout=60.0):
        """Estimate of ``compute_sigma2`` (the mean squared NN distance)
        from the prefetched band pass's per-frame nh bounds, as a float, or
        None: without a stash (none started, or the thread is still
        running after ``timeout`` seconds), or when the mean is not finite
        and positive. The stash stays for :meth:`nearest_neighbors`. The
        mean was taken on the prefetch thread, before phase 2 could fold
        into the stash's keys (the JAX engine's
        ``band_sigma2_estimate``)."""
        thread = self._band_prefetch_thread
        if thread is not None:
            thread.join(timeout)
        pf = self._band_prefetch
        if pf is None:
            return None
        val = float(pf["nh_mean"])
        return val if np.isfinite(val) and val > 0.0 else None

    # -- warms -----------------------------------------------------------------

    def _scratch(self, n_col_blocks):
        """A quiet engine of its own for the warms: this engine's D, blocks,
        device and switches over frames on a line (spacing 1 along the
        first axis) that fill ``n_col_blocks`` column blocks."""
        block = int(np.lcm(self.row_block, self.col_block))
        n = -(-n_col_blocks * self.col_block // block) * block
        coords = np.zeros((n, self.d), dtype=np.float32)
        coords[:, 0] = np.arange(n)
        eng = DensityEngine(coords, self.row_block, self.col_block,
                            device=self.device)
        eng.POPS_BIDIR, eng.NN_BIDIR = self.POPS_BIDIR, self.NN_BIDIR
        eng._quiet = True
        return eng

    def precompile_pops(self, radii, prune=True):
        """Pay the populations stage's first-use costs on the card before
        the stage, from a worker thread: the kernel library's load and the
        first launch of the stage's kernel (CUDA loads each kernel's module
        at its first launch) and of every torch op of its plan and its band
        prefetch. Nothing is compiled at run time here -- nvcc
        built the kernels once -- so this is the counterpart of the JAX
        engine's ``precompile_pops``: it runs the stage on a scratch
        engine of its own (:meth:`_scratch`, 2 * NN_BAND_BLOCKS + 1 column
        blocks) and never touches this engine's layouts, device tensors,
        band stash or ``last_stats``. Never raises (a failure is logged by
        :func:`warm_failed`); returns at once on the CPU and on a mesh."""
        if not warm_on(self.device, self.mesh):
            return
        try:
            radii = list(radii)
            eng = self._scratch(2 * NN_BAND_BLOCKS + 1)
            eng.populations(radii, prune=prune, nn_band_radius=radii[0])
            eng._take_band_prefetch()
        except Exception as exc:
            warm_failed("precompile_pops", exc)

    def precompile_nn(self, band_blocks=NN_BAND_BLOCKS):
        """The NN stage's warm, as :meth:`precompile_pops` is the
        populations stage's: the stage on a scratch engine of 2 *
        ``band_blocks`` + 1 column blocks, its phase 2 tiered at the
        default quantiles so that the tiered plan's quantile search and
        sorts run too (the JAX engine's ``precompile_nn``). Never raises;
        returns at once on the CPU and on a mesh."""
        if not warm_on(self.device, self.mesh):
            return
        try:
            eng = self._scratch(2 * band_blocks + 1)
            eng.nearest_neighbors(np.arange(eng.n, dtype=np.float32),
                                  band_blocks=band_blocks,
                                  tier_qs=self.TIER_QS_DEFAULT)
        except Exception as exc:
            warm_failed("precompile_nn", exc)

    # -- the tiered phase 2 ----------------------------------------------------

    def _nn_tiered_plan(self, rows, keys, tier_qs, bidir, stats):
        """Phase 2 re-sorted by (ub-quantile tier, position in the winner
        layout ``rows``, its (coords_t, fe, oid) for each device, the
        engine's first), each row block bounded by
        its largest tier's quantile: far fewer pairs than the block-bound
        plan when a few frames with distant lower-fe neighbours would
        widen whole row blocks (the JAX engine's ``_nn_tiered_plan`` and
        ``_nn_tiered_bidir_plan``). Tiers come from the band pass's
        distances in ``keys``. Bidirectional: every frame re-sorted, the
        active mask closed upper-triangularly; row-side: only the rows
        re-sorted, against the winner's columns; the list is planned on
        the device either way, each deal's rows on its device. Returns
        (rows, cols, tiles): the sweep's rows for each device, its columns
        for each device (None: the rows') and each deal's tile list (or
        None). ``stats`` receives the tier split: ``tier_frames``, the
        frames of each tier, and ``taus``."""
        rb, cb = self.row_block, self.col_block
        n_tiers = len(tier_qs) + 1
        d_band, _ = kernels.unpack_keys(keys)
        tier, taus = _ub_tiers(d_band, self.n, tuple(tier_qs))
        tier_w, perm = _tier_sort_perm(tier, rows[0][2], self.n, n_tiers)
        stats["tier_frames"] = torch.bincount(
            tier_w, minlength=n_tiers + 1)[:n_tiers].tolist()
        stats["taus"] = taus.tolist()
        if bidir:
            *t_rows, bound = _tiered_rows(*rows[0], tier_w, taus, perm, rb,
                                          n_tiers)
            t_rows = self._row_copies(t_rows)
            active = [_tier_active(r[0], bound, rb, cb, deal)
                      for r, (_, deal) in zip(t_rows, self._deals)]
            return t_rows, None, self._tile_lists(self._closures(active))
        *t_rows, active = _tiered_layout(*rows[0], tier_w, taus, perm, rb,
                                         cb, n_tiers)
        return [tuple(t_rows)], rows, [pruning.tile_list_device(active)]

    def _nn_tier_qs(self, tier_qs, block_tiles, bidir):
        """The quantiles of a tiered plan to try, or None: an explicit
        tuple always, None never; "auto" the default quantiles from
        TIERED_MIN_FRAMES frames when a typical 3.5x cut of
        ``block_tiles`` would save more than TIERED_MIN_SAVED_PAIRS pairs.
        A mesh keeps the row-side route block-bound (the JAX engine's
        row-only tiered plan is single-device)."""
        if tier_qs is None or not (bidir or self.mesh is None):
            return None
        if tier_qs != "auto":
            return tuple(tier_qs)
        saved = (block_tiles * float(self.row_block * self.col_block)
                 * (1.0 - 1.0 / 3.5))
        if (self.n >= self.TIERED_MIN_FRAMES
                and saved > self.TIERED_MIN_SAVED_PAIRS):
            return self.TIER_QS_DEFAULT
        return None

    def nearest_neighbors(self, free_energy, prune=True,
                          band_blocks=NN_BAND_BLOCKS, order_name=NN_BAND_ORDER,
                          tier_qs="auto"):
        """Joint NN / lower-fe NN search with two-phase exact pruning:

          1. a band pass over the frames within ``band_blocks`` column
             blocks of each position of the ``order_name`` layout bounds
             both neighbour distances of every frame;
          2. the full pass, in whichever of the dim0 and morton layouts
             sweeps less, skips tiles whose bbox distance exceeds the row
             block's bound -- tiles holding the true minima always survive.

        ``tier_qs`` (e.g. (0.5, 0.9, 0.99)) sweeps phase 2 ub-quantile
        tiered: frames re-sorted by the tier of their bound, each row
        block bounded by its tier's quantile, so that a few frames with
        distant lower-fe neighbours stop widening whole row blocks; exact
        either way. "auto" (the default) plans it only where it can pay
        (:meth:`_nn_tier_qs`) and takes it when its list saves more than
        TIERED_MIN_SAVED_PAIRS pairs; None never tiers. ``prune=False``
        (or too few column blocks for a band) sweeps every tile.

        Both passes fold into one buffer keyed by original frame id.
        Distance ties break toward the smaller original id, as in the
        reference's original-order scan. A band pass started by
        ``populations(..., nn_band_radius=r)`` is taken when its free
        energies are bit-equal to ``free_energy`` and its band, order and
        route match; otherwise it is dropped. Returns (nh_idx, nh_d2,
        nhhd_idx, nhhd_d2) numpy arrays; absent neighbours are (0, 0.0).

        ``last_stats["nn"]`` holds the route ("bidir", "symmetric",
        "-mesh" on a mesh), ``bidir``, the planner ("device"),
        ``mode`` ("tiered", "block-bound", or "dense" without a band),
        ``band_prefetched``, ``order``, the tile counts of both passes, and
        three disjoint times: ``t_plan`` (building masks, tile lists and
        phase 2's layout: the ``nn.plan`` spans), ``t_band`` (the band
        sweep, or the wait for its prefetch, and the order choice: the
        ``nn.band`` or ``nn.band_wait`` span less its ``nn.plan``) and
        ``t_sweep`` (phase 2's sweep and the readback: ``nn.phase2`` and
        ``nn.download``); on a mesh, ``per_device_tiles`` holds each pass's
        shares, {"band": .., "phase2": ..} (:func:`per_device_tiles`)."""
        fe = np.asarray(free_energy, dtype=np.float32)
        rb, cb = self.row_block, self.col_block
        nrb, ncb = self.n_pad // rb, self.n_pad // cb
        bidir = self._nn_bidir_ok()
        stats = self._stats(bidir, key="route")
        stats.update(bidir=bidir, mode="dense", band_prefetched=False,
                     band_tiles=0, phase2_tiles=0, t_plan=0.0)
        if self.mesh is not None:
            none = per_device_tiles(self.mesh, [0] * len(self._deals))
            stats["per_device_tiles"] = {"band": none, "phase2": none}
        banded = prune and ncb > 2 * band_blocks

        # the wait for a prefetched band pass (with the band pass itself
        # nested, if the prefetch does not fit), else the band pass
        pending = (self._band_prefetch_thread is not None
                   or self._band_prefetch is not None)
        with (span("nn.band_wait") if pending else span("nn.band")
              if banded else contextlib.nullcontext()) as band_span:
            pf = self._take_band_prefetch()
            if pf is not None and not (
                    banded and pf["order_name"] == order_name
                    and pf["band_blocks"] == band_blocks
                    and pf["bidir"] == bidir
                    and np.array_equal(pf["fe_band"],
                                       fe[self._layout(order_name)])):
                pf = None
            if banded:
                if pf is None:
                    with (span("nn.band") if pending
                          else contextlib.nullcontext()):
                        band = self._nn_band(
                            self._fe_layout(fe, order_name), order_name,
                            band_blocks, bidir, stats)
                else:
                    band = pf
                    stats.update(band_prefetched=True,
                                 band_tiles=pf["band_tiles"])
                keys, work = band["keys"], band["work"].tolist()
                # the smaller work wins, dim0 on ties
                pick = 1 if work[1] < work[0] else 0
                name, active = ("dim0", "morton")[pick], band["acts"][pick]
                del band, pf
                stats["order"] = name
        if banded:
            stats["t_band"] = band_span.seconds - stats["t_plan"]
        else:
            keys = kernels.nn_keys_init(self.n_pad, self.device)
            name = order_name
            active = [torch.ones((pruning.deal_rows(nrb, deal), ncb),
                                 dtype=torch.bool, device=dev)
                      for dev, deal in self._deals]
        with span("nn.plan") as plan, planning(self.mesh):
            if bidir:
                active = self._closures(active)
            tiles = self._tile_lists(active)
            del active
            rows = self._nn_rows(name, self._fe_layout(fe, name))
            cols = None
            if banded:
                stats["mode"] = "block-bound"
                block_tiles = sum(self._tile_counts(tiles)[1])
                qs = self._nn_tier_qs(tier_qs, block_tiles, bidir)
                if qs is not None:
                    t_rows, t_cols, t_tiles = self._nn_tiered_plan(
                        rows, keys, qs, bidir, stats)
                    est = sum(self._tile_counts(t_tiles)[1])
                    saved = (block_tiles - est) * float(rb * cb)
                    if (tier_qs != "auto"
                            or saved > self.TIERED_MIN_SAVED_PAIRS):
                        stats["mode"] = "tiered"
                        rows, cols, tiles = t_rows, t_cols, t_tiles
                    del t_rows, t_cols, t_tiles
        stats["t_plan"] += plan.seconds
        with span("nn.phase2") as phase2:
            self._nn_sweep(rows, tiles, keys, bidir, stats, "phase2",
                           cols=cols)
            del rows, cols, tiles
        with span("nn.download") as download:
            d2, ids = kernels.unpack_keys(keys[:, :self.n])
            absent = ~(d2 < float("inf"))
            ids = torch.where(absent, 0, ids)
            d2 = pair_d2(self._put(self.coords), ids)
            d2 = torch.where(absent, 0.0, d2)
            ids = ids.cpu().numpy()
            d2 = d2.cpu().numpy()
        stats["t_sweep"] = phase2.seconds + download.seconds
        stats["computed_tiles"] = stats["band_tiles"] + stats["phase2_tiles"]
        self.last_stats["nn"] = stats
        self._log_stats("nn", stats["computed_tiles"],
                        f", {stats['mode']} phase 2"
                        + (", band prefetched" if stats["band_prefetched"]
                           else ""))
        return ids[0], d2[0], ids[1], d2[1]
