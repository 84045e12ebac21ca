"""Free-energy screening: density-connected microstate assignment.

Counterpart of ``clustering_tpu/ops/screening.py`` on its default
single-chip path. The frames below a free-energy threshold (the first
``n_below`` positions of the layout) are partitioned into the connected
components of the graph i ~ j iff d2(i, j) < max_dist2 (= 4 sigma^2),
with seed labels acting as permanent equivalences.

Labels are int32 frame pointers in layout positions. The fixpoint is
host-driven: each sweep runs a label-min kernel over the tile list, then a
scatter-min union over the label table with pointer jumping, then new
dirty flags; one scalar readback per sweep decides whether to go on. The
last sweep is the verification sweep that changes nothing. Two sweeps
reach the same fixpoint:

  bidir: the bidirectional kernel over the upper-triangular list, a tile
  swept when its row or its column block is dirty;
  symmetric: the row-side kernel over the full list (both orientations),
  a tile swept when its column block is dirty.

Both sweeps' tile lists are planned on the device.

With a mesh (``parallel.mesh``), each device plans the tiles of the row
blocks dealt to it (its own strict-< plane over those rows) and sweeps
them against copies of its own of the coordinates, the labels and the
dirty flags, and the swept labels (bidir) or proposals (symmetric)
merge by a MIN before the union (the counterpart of the JAX package's
``_screening_sharded_pallas_bidir``); on a group's mesh a rank's devices
merge on its primary device, then over the ranks by ``all_reduce``. The
union runs once per process, on the primary device, and the labels and
flags go back out to its devices for the next sweep; on a group's mesh
it runs on identical tensors on every rank, so convergence needs no
other collective. Every device's share is launched before the sweep's
one readback.
"""

import numpy as np
import torch

from ..utils.logger import is_verbose, logger
from ..utils.timer import adopt, count, current, span

from ..parallel.mesh import LocalMesh, planning, skew
from . import kernels, pruning
from .engine import (DEFAULT_COL_BLOCK, DEFAULT_ROW_BLOCK, engine_device,
                     per_device_tiles, resolve_backend, warm_failed,
                     warm_on)


def pointer_jump(table):
    """Compress label chains until table == table[table]."""
    while True:
        nxt = table[table.long()]
        if torch.equal(nxt, table):
            return table
        table = nxt


def screen_active(below, n_below, row_lo, row_block, col_block, triangular,
                  rows=None):
    """Tiles that can hold an admissible pair: the strict-< bbox plane
    ``below`` (a tensor on any device, or numpy: the tests' reference,
    which no sweep plans with) inside the n_below prefix, touching the
    new-frame cross when ``row_lo`` > 0, and (``triangular``)
    intersecting the upper triangle. ``rows``: the deal of row blocks
    that ``below``'s rows are (a tensor's; None: all)."""
    nrb, ncb = below.shape
    if isinstance(below, torch.Tensor):
        ri = pruning.row_ids(nrb, rows, below.device)
        cj = torch.arange(ncb, device=below.device)[None, :]
    else:
        ri = np.arange(nrb)[:, None]
        cj = np.arange(ncb)[None, :]
    active = below & (ri * row_block < n_below) & (cj * col_block < n_below)
    if row_lo > 0:
        active = active & (((ri + 1) * row_block > row_lo)
                           | ((cj + 1) * col_block > row_lo))
    if triangular:
        active = active & ((cj + 1) * col_block > ri * row_block)
    return active


def union_rebase(labels_in, labels_cur):
    """Label-granularity union: every frame sharing a pre-sweep label is
    rebased to the minimum post-sweep label proposed for it."""
    iota = torch.arange(labels_in.shape[0], dtype=labels_in.dtype,
                        device=labels_in.device)
    table = iota.scatter_reduce(0, labels_in.long(), labels_cur, "amin")
    table = pointer_jump(table)
    return table[labels_in.long()]


class ScreeningEngine:
    """Screening runner over one (layout-ordered) frame matrix on
    ``device``: pads and uploads the coordinates once and caches the
    strict-< bbox activity plane per linking distance.

    Any (row_block, col_block) pair is served: N is padded to their least
    common multiple. The fixpoint sweeps bidirectionally when ``BIDIR``
    is on (the counterpart of the JAX engine's ``BIDIR_UNION_VMEM``, which
    0 turns off) and col_block % row_block == 0 (the row-dirty flags
    reshape the union into row blocks), else symmetrically. With a
    ``mesh`` each device sweeps its share of the list, and the engine's
    device is the mesh's primary one (``device`` may name it).
    ``backend`` is the JAX engine's: "auto" and "pallas" select the
    tile-sweep route, anything else raises ValueError."""

    BIDIR = True
    # set on the warm's scratch engine (ThresholdSeriesScreener.precompile)
    _quiet = False

    def __init__(self, coords_sorted, row_block=DEFAULT_ROW_BLOCK,
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
        coords_sorted = np.asarray(coords_sorted, dtype=np.float32)
        self.n = coords_sorted.shape[0]
        block = int(np.lcm(row_block, col_block))
        self.n_pad = -(-self.n // block) * block
        padded = np.full((self.n_pad, coords_sorted.shape[1]),
                         np.float32(3e38), dtype=np.float32)
        padded[:self.n] = coords_sorted
        self.coords_t = torch.as_tensor(np.ascontiguousarray(padded.T),
                                        device=self.device)
        # each device's own coordinates, the first the engine's
        self._coords_copies = self._spread.copies(self.coords_t)
        # (max_dist2, each deal's strict-< bool plane on its device)
        self._below = None
        self.last_stats = {}

    def _below_plane(self, max_dist2, part=0):
        """The strict-< bbox activity plane at ``max_dist2`` of the row
        blocks of deal ``part`` (all of them without a mesh), on its
        device; every deal's is built at once, each from its device's
        coordinates, and the bbox distances are dropped once thresholded
        (512 MB at 2^23 frames)."""
        key = float(max_dist2)
        if self._below is None or self._below[0] != key:
            self._below = None
            planes = []
            for ct, (_, rows) in zip(self._coords_copies, self._deals):
                d2b = pruning.bbox_d2(ct, self.row_block, self.col_block,
                                      rows=rows)
                planes.append(pruning.le_planes_device(
                    d2b, [np.float32(max_dist2)], strict=True)[0])
                del d2b
            self._below = (key, planes)
        return self._below[1][part]

    def tile_list(self, row_lo, n_below, max_dist2, triangular=True,
                  part=0):
        """The tiles of :func:`screen_active` at this linking distance in
        the row blocks of deal ``part`` (all of them without a mesh),
        planned on its device: a flat row-major (ti, tj) list of int32
        tensors, or None; the bidirectional sweep's list when
        ``triangular``, else the symmetric sweep's."""
        rows = self._deals[part][1]
        return pruning.tile_list_device(screen_active(
            self._below_plane(max_dist2, part), n_below, row_lo,
            self.row_block, self.col_block, triangular, rows), rows)

    def union_size(self, n_below):
        """Union prefix: power-of-two col-block count >= n_below."""
        nub = 1 << int(np.ceil(np.log2(
            max(-(-n_below // self.col_block), 1))))
        return min(nub * self.col_block, self.n_pad)

    def _bidir_ok(self):
        return self.BIDIR and self.col_block % self.row_block == 0

    def _union_step(self, labels_in, labels_swept, union_size, rows):
        """Union + pointer jumping + dirty flags of one sweep: per column
        block, and per row block too when ``rows`` (else None)."""
        rb, cb = self.row_block, self.col_block
        head_in = labels_in[:union_size]
        head_out = union_rebase(head_in, labels_swept[:union_size])
        changed = head_out != head_in
        labels_out = torch.cat([head_out, labels_in[union_size:]])
        dirty_col = torch.zeros(self.n_pad // cb, dtype=torch.bool,
                                device=self.device)
        dirty_col[:union_size // cb] = changed.reshape(-1, cb).any(dim=1)
        dirty_row = None
        if rows:
            dirty_row = torch.zeros(self.n_pad // rb, dtype=torch.bool,
                                    device=self.device)
            dirty_row[:union_size // rb] = changed.reshape(-1, rb).any(dim=1)
        return labels_out, bool(changed.any()), dirty_col, dirty_row

    def run_device(self, labels, n_below, max_dist2, row_lo=0):
        """Fixpoint from (N_pad,) int32 device labels; ``row_lo`` > 0
        marks a series continuation whose first row_lo positions already
        carry a completed fixpoint at this max_dist2, so only tiles
        touching the new frames are swept. Returns new device labels.
        ``swept_tiles`` counts the tiles this process swept (on a group's
        mesh, this rank's shares); on a mesh, ``per_device_tiles`` holds
        the shares as the density engine's do. ``t_plan`` and
        ``t_fixpoint`` are the seconds of the ``screening.plan`` and
        ``screening.fixpoint`` spans; the latter counts ``sweeps`` and
        ``swept_tiles``."""
        bidir = self._bidir_ok()
        with span("screening.plan") as plan_span, planning(self.mesh):
            lists = [self.tile_list(row_lo, n_below, max_dist2,
                                    triangular=bidir, part=k)
                     for k in range(len(self._deals))]
            counts = [0 if t is None else len(t[0]) for t in lists]
            everyone = self._spread.all_counts(counts)
            n_tiles = sum(everyone)
            if not n_tiles:
                return labels
            empty = [torch.zeros(0, dtype=torch.int32, device=dev)
                     for dev, _ in self._deals]
            shares = [t or (e, e) for t, e in zip(lists, empty)]
            del lists
        with span("screening.fixpoint") as fixpoint:
            ratio = skew(everyone)
            if ratio is not None:
                count("tiles_max_over_mean", ratio)
            labels, iters, swept = self._fixpoint(labels, n_below,
                                                  max_dist2, bidir, shares)
            count("sweeps", iters)
            count("swept_tiles", swept)
            mode = "bidir" if bidir else "symmetric"
            stats = {"sweeps": iters, "tiles_per_sweep": n_tiles,
                     "swept_tiles": swept, "mode": mode, "plan": "device",
                     "t_plan": plan_span.seconds}
            tag = ""
            if self.mesh is not None:
                tag = "mesh "
                stats.update(mode=mode + "-mesh",
                             mesh_devices=self.mesh.size,
                             per_device_tiles=per_device_tiles(
                                 self.mesh, counts))
            if is_verbose() and not self._quiet:
                logger(f"    [{tag}screening fixpoint: {iters} sweeps,"
                       f" {n_tiles} tiles/sweep, {swept} swept, {mode},"
                       " device plan, host-driven]")
        stats["t_fixpoint"] = fixpoint.seconds
        self.last_stats = stats
        return labels

    def _fixpoint(self, labels, n_below, max_dist2, bidir, shares):
        """The sweeps of :meth:`run_device` over each device's tile
        ``shares`` until the union changes nothing: (the labels, the
        sweeps, the tiles swept)."""
        rb, cb = self.row_block, self.col_block
        union_size = self.union_size(n_below)
        dirty_col = torch.ones(self.n_pad // cb, dtype=torch.bool,
                               device=self.device)
        dirty_row = (torch.ones(self.n_pad // rb, dtype=torch.bool,
                                device=self.device) if bidir else None)
        iters = 0
        swept = torch.zeros((), dtype=torch.int64, device=self.device)
        while True:
            # every device's share is launched before the sweep's readback
            # (the union's ``changed``), so that the devices run together
            dcols = self._spread.copies(dirty_col)
            drows = self._spread.copies(dirty_row) if bidir else None
            parts, counts = [], []
            for k, (ct, lab, (ti, tj)) in enumerate(zip(
                    self._coords_copies, self._spread.copies(labels),
                    shares)):
                if bidir:
                    dirty = dcols[k][tj.long()] | drows[k][ti.long()]
                    counts.append(dirty.sum())
                    parts.append(kernels.label_min_bidir(
                        ct, lab, n_below, max_dist2, ti, tj,
                        dirty.to(torch.int32), rb, cb))
                else:
                    counts.append(dcols[k][tj.long()].sum())
                    parts.append(kernels.label_min_sparse(
                        ct, ct, lab, n_below, max_dist2, ti, tj, 0,
                        dcols[k].to(torch.int32), rb, cb))
            merged = self._spread.min(parts)
            labels_swept = merged if bidir else torch.minimum(labels, merged)
            for c in counts:
                swept += c.to(self.device)
            labels, changed, dirty_col, dirty_row = self._union_step(
                labels, labels_swept, union_size, bidir)
            iters += 1
            if not changed:
                break
        return labels, iters, int(swept)

    def run(self, initial_labels, n_below, max_dist2, row_lo=0):
        """Host wrapper of :meth:`run_device`: (N,) labels in and out."""
        labels = np.asarray(initial_labels, dtype=np.int32)
        labels = np.concatenate(
            [labels, np.arange(self.n, self.n_pad, dtype=np.int32)])
        out = self.run_device(torch.as_tensor(labels, device=self.device),
                              n_below, max_dist2, row_lo=row_lo)
        return out[:self.n].cpu().numpy()


class ThresholdSeriesScreener:
    """Screening runner for a known -T threshold series.

    Frames are laid out in (threshold band, Morton) order: the prefix
    below every series threshold stays contiguous while Morton order
    inside each band keeps tile bounding boxes tight. Clusters are named
    by their minimal FE-sorted frame rank, as in the reference. With a
    ``mesh`` (either kind), each device plans and sweeps the tiles of its
    own row blocks at every step, from the main thread (``step_submit``'s
    pool only downloads).

    ``morton_order`` is the (n,) int64 Morton order of ``coords``
    (``pruning.morton_order``) when the caller already holds it, as the
    density engine does (``DensityEngine.layout_order("morton")``); else
    the build computes it.

    The build runs in a ``screener.build`` span (``build_seconds``)
    whose counter ``morton_reused`` is 1 when the order was handed in,
    with children ``screener.morton`` (only when it was not),
    ``screener.sort`` (the series order), ``screener.fe_sort`` (the
    naming order), ``screener.gather`` and ``screener.upload``."""

    def __init__(self, coords, free_energy, thresholds,
                 row_block=DEFAULT_ROW_BLOCK, col_block=DEFAULT_COL_BLOCK,
                 backend="auto", mesh=None, hd_neighbors=None,
                 device=None, morton_order=None):
        with span("screener.build") as build:
            self._build(coords, free_energy, thresholds, row_block,
                        col_block, backend, mesh, hd_neighbors, device,
                        morton_order)
        self.build_seconds = build.seconds

    def _build(self, coords, free_energy, thresholds, row_block, col_block,
               backend, mesh, hd_neighbors, device, morton_order):
        coords = np.asarray(coords, dtype=np.float32)
        fe = np.asarray(free_energy, dtype=np.float32)
        self.thresholds = [np.float32(t) for t in thresholds]
        if any(a >= b for a, b in zip(self.thresholds,
                                      self.thresholds[1:])):
            raise ValueError("thresholds must be strictly ascending, got "
                             f"{[float(t) for t in self.thresholds]}")
        n = len(fe)
        count("morton_reused", int(morton_order is not None))
        if morton_order is None:
            with span("screener.morton"):
                morton_order = pruning.morton_order(coords)
        elif len(morton_order) != n:
            raise ValueError(f"morton_order has {len(morton_order)} frames,"
                             f" the free energies {n}")
        # band k = first series threshold at or above this frame's fe, in
        # the narrowest type that holds len(thresholds), for which numpy's
        # stable sort is a radix sort
        band = np.searchsorted(self.thresholds, fe, side="left").astype(
            np.min_scalar_type(len(self.thresholds)))
        with span("screener.sort"):
            # (band, Morton rank) order: a stable partition of the Morton
            # order by band keeps Morton order inside each band
            self.order = morton_order[np.argsort(band[morton_order],
                                                 kind="stable")]
            self._series_rank = np.empty(n, dtype=np.int64)
            self._series_rank[self.order] = np.arange(n)
        self.n_below_per_band = np.cumsum(
            np.bincount(band, minlength=len(self.thresholds) + 1)
        )[:len(self.thresholds)]
        with span("screener.fe_sort"):
            fe_order = np.argsort(fe, kind="stable")
            # series positions in FE-ascending frame order (for naming)
            self._fe_asc_pos = self._series_rank[fe_order]
        with span("screener.gather"):
            coords_sorted = coords[self.order]
        with span("screener.upload"):
            self.engine = ScreeningEngine(coords_sorted, row_block,
                                          col_block, backend, mesh, device)
        del coords_sorted  # the engine holds its padded copy
        self.n = n
        self._prev_nb = 0
        self._labels = None
        self._last_out = None
        self._last_future = None
        self._hd_pos = None
        if hd_neighbors is not None:
            self.set_hd_neighbors(hd_neighbors)

    def set_hd_neighbors(self, hd_neighbors):
        """Attach the NN stage's nearest-lower-fe edges (hd_idx, hd_d2)
        per original frame: below the linking distance each is a genuine
        screening edge whose endpoint is admitted first, so new frames
        seed their labels with it (same components, fewer sweeps). A
        ``screener.hd_neighbors`` span."""
        with span("screener.hd_neighbors"):
            hd_j = np.asarray(hd_neighbors[0], dtype=np.int64)
            hd_d = np.asarray(hd_neighbors[1], dtype=np.float32)
            self._hd_pos = self._series_rank[hd_j[self.order]].astype(
                np.int32)
            self._hd_d = hd_d[self.order]

    def precompile(self, max_dist2, compile_only=False):
        """Pay the screening steps' first-use costs on the card before the
        first step, from a worker thread: the kernel library's load and the
        first launch of the fixpoint's kernel and of every torch op of its
        plan, union and pointer jumping. The counterpart of the JAX
        screener's ``precompile``, which compiles each step's program;
        here nvcc built the kernels once and nothing compiles at run time,
        so there is no compile to separate from execution, and
        ``compile_only`` changes nothing: either way the fixpoint runs at
        ``max_dist2`` on a scratch engine of one grid block of coincident
        frames, cold and then as a continuation, and never at the real
        size. Never touches this screener's state. Never raises (a failure
        is logged by ``engine.warm_failed``); returns at once on the CPU
        and on a mesh."""
        eng = self.engine
        if not warm_on(eng.device, eng.mesh):
            return
        try:
            n = int(np.lcm(eng.row_block, eng.col_block))
            scratch = ScreeningEngine(np.zeros((n, eng.coords_t.shape[0]),
                                               dtype=np.float32),
                                      eng.row_block, eng.col_block,
                                      device=eng.device)
            scratch.BIDIR = eng.BIDIR
            scratch._quiet = True
            labels = scratch.run(np.arange(n, dtype=np.int32), n // 2,
                                 max_dist2)
            scratch.run(labels, n, max_dist2, row_lo=n // 2)
        except Exception as exc:
            warm_failed("screener precompile", exc)

    def _seed_vals(self, lo, hi, max_dist2):
        """Seeds for positions [lo, hi): the hd edge when it lies below the
        linking distance, else identity; None without hd data."""
        if self._hd_pos is None or hi <= lo:
            return None
        hdd = self._hd_d[lo:hi]
        ok = (hdd > 0.0) & (hdd < np.float32(max_dist2))
        return np.where(ok, self._hd_pos[lo:hi],
                        np.arange(lo, hi, dtype=np.int32))

    def _upload(self, labels):
        return torch.as_tensor(np.ascontiguousarray(labels, dtype=np.int32),
                               device=self.engine.device)

    def _cold_seed(self, nb, max_dist2):
        labels0 = np.arange(self.engine.n_pad, dtype=np.int32)
        seeds = self._seed_vals(0, nb, max_dist2)
        if seeds is not None:
            labels0[:nb] = seeds
        return self._upload(labels0), 0

    def _continuation_seed(self, nb, max_dist2):
        prev_last = int(self._prev_nb)
        labels = self._labels
        seeds = self._seed_vals(prev_last, nb, max_dist2)
        if seeds is not None:
            labels = labels.clone()
            labels[prev_last:nb] = self._upload(seeds)
        return labels, prev_last

    def _generic_seed(self, prev_clustering, nb, max_dist2):
        """Seed from an arbitrary previous clustering: first-occurrence
        pointers per state; the sweep must then cover every tile."""
        prev = np.asarray(prev_clustering, dtype=np.int64)
        ps = prev[self.order]
        ps[nb:] = 0
        zeros = np.flatnonzero(ps == 0)
        prev_last = int(zeros[0]) if len(zeros) else self.n
        labels0 = np.arange(self.engine.n_pad, dtype=np.int64)
        prefix = ps[:nb]
        seeded = prefix != 0
        if seeded.any():
            vals, first_idx = np.unique(prefix[seeded], return_index=True)
            seeded_pos = np.flatnonzero(seeded)
            first_occ = seeded_pos[first_idx]
            labels0[seeded_pos] = first_occ[
                np.searchsorted(vals, prefix[seeded])]
        seeds = self._seed_vals(prev_last, nb, max_dist2)
        if seeds is not None:
            seg = labels0[prev_last:nb]
            unassigned = seg == np.arange(prev_last, nb)
            seg[unassigned] = seeds[unassigned]
        # full sweep from row 0: the seed is not a known fixpoint
        return self._upload(labels0), 0

    def step(self, prev_clustering, k, max_dist2):
        """Run series threshold index ``k``; returns the normalized
        clustered trajectory in original frame order. Passing the array
        the previous ``step`` returned continues from the device labels."""
        nb = int(self.n_below_per_band[k])
        continuing = (prev_clustering is not None
                      and prev_clustering is self._last_out
                      and self._labels is not None)
        if continuing:
            labels, prev_last = self._continuation_seed(nb, max_dist2)
        elif prev_clustering is None:
            labels, prev_last = self._cold_seed(nb, max_dist2)
        else:
            labels, prev_last = self._generic_seed(prev_clustering, nb,
                                                   max_dist2)
        if prev_last >= nb:
            # nothing new below this threshold: keep the previous result
            out = (np.zeros(self.n, dtype=np.int64) if prev_clustering is None
                   else np.asarray(prev_clustering, dtype=np.int64).copy())
            self._last_out = out
            return out
        labels = self.engine.run_device(labels, nb, max_dist2,
                                        row_lo=prev_last)
        self._labels = labels
        self._prev_nb = nb
        with span("screening.post"):
            out = self._postlude(labels[:nb].cpu().numpy(), nb)
        self._last_out = out
        return out

    def _postlude(self, final, nb):
        """Name components 1..K by their minimal FE-sorted rank; returns
        the clustered trajectory in original frame order."""
        comp = np.asarray(final[:nb], dtype=np.int64)
        fe_asc = self._fe_asc_pos[self._fe_asc_pos < nb]
        comp_vals, first_at = np.unique(comp[fe_asc], return_index=True)
        names = np.empty(len(comp_vals), dtype=np.int64)
        names[np.argsort(first_at, kind="stable")] = \
            np.arange(1, len(comp_vals) + 1)
        clustering = np.zeros(self.n, dtype=np.int64)
        clustering[self.order[:nb]] = names[np.searchsorted(comp_vals, comp)]
        return clustering

    def reset(self):
        """Forget all series state; the next step is a cold start."""
        self._prev_nb = 0
        self._labels = None
        self._last_out = None
        self._last_future = None

    def step_submit(self, k, max_dist2, pool):
        """Series-order step whose host postlude (label download and
        naming) runs on ``pool``, in a ``screening.post`` span whose parent
        is the span open here; returns the Future of what ``step``
        returns. The whole series must be driven in ascending order
        through this method from a fresh (or reset) screener."""
        import concurrent.futures
        nb = int(self.n_below_per_band[k])
        cold = self._labels is None
        if cold:
            labels, prev_last = self._cold_seed(nb, max_dist2)
        else:
            labels, prev_last = self._continuation_seed(nb, max_dist2)
        if prev_last >= nb:
            prev_fut = self._last_future
            out = concurrent.futures.Future()
            if cold or prev_fut is None:
                out.set_result(np.zeros(self.n, dtype=np.int64))
            else:
                def _chain(f):
                    try:
                        out.set_result(f.result().copy())
                    except BaseException as exc:  # propagate, don't hang
                        out.set_exception(exc)
                prev_fut.add_done_callback(_chain)
            self._last_future = out
            return out
        labels = self.engine.run_device(labels, nb, max_dist2,
                                        row_lo=prev_last)
        self._labels = labels
        self._prev_nb = nb
        # the prefix snapshot is taken in stream order on this thread;
        # the worker only downloads it
        prefix = labels[:nb].clone()
        parent = current()

        def post():
            with adopt(parent), span("screening.post"):
                return self._postlude(prefix.cpu().numpy(), nb)
        fut = pool.submit(post)
        self._last_future = fut
        return fut


def screening_labels(coords_sorted, initial_labels, n_below, max_dist2,
                     row_block=DEFAULT_ROW_BLOCK, col_block=DEFAULT_COL_BLOCK,
                     backend="auto", device="cuda"):
    """Host wrapper: pad, run the fixpoint, unpad.

    ``coords_sorted`` (N, D) must already be in FE-ascending order and
    ``initial_labels`` (N,) int32 frame pointers with labels[i] <= i.
    ``backend``: as :class:`ScreeningEngine`'s."""
    engine = ScreeningEngine(coords_sorted, row_block, col_block, backend,
                             device=device)
    return engine.run(initial_labels, n_below, max_dist2)
