"""The pairwise tile-sweep kernels: CUDA wrappers, plain versions and
launch counts.

Three families: the bidirectional kernels (``*_bidir``) sweep an
upper-triangular tile list and serve both frames of every pair; the
symmetric, row-side kernels (``*_sparse``) serve only the row frame, so
their tile lists hold both orientations; the dense-grid kernels
(``pops_tiles``, ``nn_tiles``) visit every cell of the row-block x
column-block grid and skip the cells whose bit is set in the packed skip
words of :mod:`.pruning`. The row-side and dense-grid kernels take the
cross form of the JAX package: a row matrix ``rows_t`` (D, R_pad) apart
from the column matrix ``cols_t`` (D, N_pad); the single-device path
passes one matrix twice.

Each wrapper takes its plain PyTorch version only because its tensors lie
on the CPU; for CUDA tensors it launches the hand-written kernel from
``clustering_tpu_torch/csrc`` (built by :mod:`._build`) or raises. Every
plain version has the wrapper's signature and runs on any device, so the
card can hold each kernel against it.

Tile lists are flat int32 (ti, tj) pairs over the (row_block x
col_block) grid of (D, N_pad) float32 coordinate matrices whose pads sit
at 3e38; the planners emit them row-major, and no result depends on the
order (the row-side NN and label-min wrappers reorder theirs with
:func:`wave_order`).

``LAUNCHES`` counts the kernel launches of each wrapper (plain calls do
not count); :func:`reset_launches` sets every count to 0. The enclosing
span (``utils.timer``) counts them too, as ``<kernel>.launches``, and the
tiles of each tile-list wrapper's calls, plain or not, as
``<kernel>.tiles`` (the tiles listed: a label-min sweep evaluates only
the dirty ones, which the fixpoint's span counts as ``swept_tiles``).
"""

import ctypes

import numpy as np
import torch

from ..utils import timer
from .pairwise import sq_dists

IMAX = int(np.iinfo(np.int32).max)
# (float_bits(+inf) << 32) | INT32_MAX: "no neighbour", above every
# finite (d2, id) key
KEY_NONE = (0x7F800000 << 32) | IMAX
MAX_RADII_PER_LAUNCH = 8
# slots of the step counts of pops_bidir's several-radii instances
# (csrc/pops_bidir.cu STEP_SLOTS)
STEP_SLOTS = 128
DEFAULT_ROW_BLOCK = 128
DEFAULT_COL_BLOCK = 4096

LAUNCHES = {"pops_bidir": 0, "nn_bidir": 0, "label_min_bidir": 0,
            "pops_sparse": 0, "nn_sparse": 0, "label_min_sparse": 0,
            "pops_tiles": 0, "nn_tiles": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- shared helpers -----------------------------------------------------------

def _batches(ti, tj, row_block, col_block, *extra):
    """Yield (rows, cols, *extra) tile batches: rows (B, row_block) and
    cols (B, col_block) int64 frame positions, sized so one batch's
    (B, row_block, col_block) pair block stays near 2^24 elements."""
    per = max(1, (1 << 24) // (row_block * col_block))
    dev = ti.device
    ar_r = torch.arange(row_block, device=dev)
    ar_c = torch.arange(col_block, device=dev)
    for lo in range(0, ti.shape[0], per):
        rows = ti[lo:lo + per].long()[:, None] * row_block + ar_r
        cols = tj[lo:lo + per].long()[:, None] * col_block + ar_c
        yield (rows, cols) + tuple(e[lo:lo + per] for e in extra)


def _tile_d2(rows_t, rows, cols_t, cols):
    x = rows_t[:, rows].permute(1, 2, 0)
    y = cols_t[:, cols].permute(1, 2, 0)
    return sq_dists(x, y)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check(cond, msg):
    if not cond:
        raise ValueError(msg)


def _check_cuda(coords_t, tensors, ints):
    """Device, dtype, shape and contiguity checks before a launch."""
    _check(coords_t.device.type == "cuda",
           "the coordinates must be a CUDA tensor")
    _check(coords_t.dtype == torch.float32 and coords_t.dim() == 2
           and coords_t.is_contiguous(),
           "the coordinates must be a contiguous (D, N_pad) float32 tensor")
    for name, t, dtype, shape in tensors:
        _check(t.device == coords_t.device,
               f"{name} must be on {coords_t.device}")
        _check(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _check(tuple(t.shape) == tuple(shape),
               f"{name} must have shape {tuple(shape)}, got "
               f"{tuple(t.shape)}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    for name, v in ints:
        _check(0 <= int(v) <= IMAX, f"{name} out of int32 range")


def _run(fn_name, count_name, *args):
    from . import _build
    lib = _build.library()
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed (cudaError {rc})")
    LAUNCHES[count_name] += 1
    timer.count(count_name + ".launches")


def _tally(name, ti):
    """Count the tiles of a call's list on the enclosing span (host
    metadata: no sync), whichever version runs."""
    timer.count(name + ".tiles", int(ti.shape[0]))


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def wave_order(ti, tj, row_block, col_block, n_row_blocks, n_col_blocks,
               row_block_offset=0):
    """Permutation (int64) that runs a tile list in waves by distance from
    each row block's diagonal column block jd (the column block that holds
    the row block's first global frame, at most the last one): tiles with
    tj = jd first, then jd + 1, jd - 1, jd + 2, ..., each wave in row block
    order; tj < 0 entries last. One stable argsort of (wave rank, ti) on
    the list's device, with no host sync.

    The row-side kernels read their rows' bounds from their output buffer
    at each pass start, so a tile that runs after its row block's diagonal
    tiles starts from near-final bounds; their results do not depend on the
    order."""
    ti, tj = ti.long(), tj.long()
    jd = ((ti + int(row_block_offset)) * row_block
          // col_block).clamp_max(n_col_blocks - 1)
    delta = tj - jd
    rank = torch.where(delta > 0, 2 * delta - 1, -2 * delta)
    rank = torch.where(tj < 0, 2 * n_col_blocks + 1, rank)
    return torch.argsort(rank * n_row_blocks + ti, stable=True)


def _grid(rows_t, cols_t, row_block, col_block):
    _check(rows_t.shape[1] % row_block == 0,
           "the row count must be a multiple of row_block")
    _check(cols_t.shape[1] % col_block == 0,
           "the column count must be a multiple of col_block")
    _check(1 <= row_block <= 1024, "row_block must be in [1, 1024]")


# -- populations ----------------------------------------------------------------

def pops_bidir_plain(coords_t, radii2, n_valid, ti, tj, rmask, row_block,
                     col_block):
    """Plain version of :func:`pops_bidir`."""
    n_pad = coords_t.shape[1]
    n_radii = radii2.shape[0]
    out = torch.zeros((n_radii, n_pad), dtype=torch.int32,
                      device=coords_t.device)
    keep = (tj >= 0) & (rmask != 0)
    ti, tj, rmask = ti[keep], tj[keep], rmask[keep]
    for rows, cols, rm in _batches(ti, tj, row_block, col_block, rmask):
        d2 = _tile_d2(coords_t, rows, coords_t, cols)
        base = ((cols[:, None, :] > rows[:, :, None])
                & (cols[:, None, :] < n_valid))
        for r in range(n_radii):
            bit = ((rm >> r) & 1).bool()[:, None, None]
            w = base & bit & (d2 <= radii2[r])
            out[r].index_add_(0, rows.reshape(-1),
                              w.sum(dim=2, dtype=torch.int32).reshape(-1))
            out[r].index_add_(0, cols.reshape(-1),
                              w.sum(dim=1, dtype=torch.int32).reshape(-1))
    return out


def pops_bidir(coords_t, radii2, n_valid, ti, tj, rmask, row_block,
               col_block):
    """Bidirectional population counts over an upper-triangular tile list
    (replaces ``_pops_bidir_kernel``).

    Each strictly-upper pair row < col < n_valid of a tile with
    d2 <= radii2[r] and bit r of its ``rmask`` set adds 1 to both frames.
    The self count (``_add_self_count``) is the caller's, added once after
    any merge of partial counts. Returns (R, N_pad) int32 counts in the
    layout's frame positions.

    The launches of several radii count, on the card, the (warp, step)
    pairs that computed distances and the (warp, step, radius) triples
    whose count ran (a warp skips the radii that none of a step's pairs
    reaches): ``pops_bidir.warp_steps`` and ``pops_bidir.radius_steps`` on
    the enclosing span, summed once its owner settles it
    (``utils.timer.count_pending``); one radius counts neither."""
    _tally("pops_bidir", ti)
    if coords_t.device.type == "cpu":
        return pops_bidir_plain(coords_t, radii2, n_valid, ti, tj, rmask,
                                row_block, col_block)
    n_dim, n_pad = coords_t.shape
    n_radii = radii2.shape[0]
    n_tiles = ti.shape[0]
    _check_cuda(coords_t, [
        ("radii2", radii2, torch.float32, (n_radii,)),
        ("ti", ti, torch.int32, (n_tiles,)),
        ("tj", tj, torch.int32, (n_tiles,)),
        ("rmask", rmask, torch.int32, (n_tiles,))], [("n_valid", n_valid)])
    _grid(coords_t, coords_t, row_block, col_block)
    _check(1 <= n_radii <= 31, "1 to 31 radii are supported")
    out = torch.zeros((n_radii, n_pad), dtype=torch.int32,
                      device=coords_t.device)
    steps = None
    if n_radii > 1 and n_tiles:
        # (warp steps, radius steps) per slot
        steps = torch.zeros((STEP_SLOTS, 2), dtype=torch.int64,
                            device=coords_t.device)
    with torch.cuda.device(coords_t.device):
        stream = _stream(coords_t.device)
        for g in range(0, n_radii, MAX_RADII_PER_LAUNCH):
            n_g = min(MAX_RADII_PER_LAUNCH, n_radii - g)
            rm_g = ((rmask >> g) & ((1 << n_g) - 1)).contiguous()
            if n_tiles == 0:
                continue
            _run("ck_pops_bidir", "pops_bidir", _ptr(coords_t), n_pad,
                 n_dim, _ptr(radii2[g:]), n_g, int(n_valid), _ptr(ti),
                 _ptr(tj), _ptr(rm_g), n_tiles, row_block, col_block,
                 _ptr(out[g:]), ctypes.c_void_p(None) if steps is None
                 else _ptr(steps), stream)
    if steps is not None:
        timer.count_pending("pops_bidir.warp_steps", steps[:, 0])
        timer.count_pending("pops_bidir.radius_steps", steps[:, 1])
    return out

def pops_sparse_plain(rows_t, cols_t, radii2, n_valid, ti, tj, rmask,
                      row_block, col_block):
    """Plain version of :func:`pops_sparse`."""
    n_radii = radii2.shape[0]
    out = torch.zeros((n_radii, rows_t.shape[1]), dtype=torch.int32,
                      device=rows_t.device)
    keep = (tj >= 0) & (rmask != 0)
    for rows, cols, rm in _batches(ti[keep], tj[keep], row_block, col_block,
                                   rmask[keep]):
        d2 = _tile_d2(rows_t, rows, cols_t, cols)
        valid = (cols < n_valid)[:, None, :]
        for r in range(n_radii):
            bit = ((rm >> r) & 1).bool()[:, None, None]
            w = valid & bit & (d2 <= radii2[r])
            out[r].index_add_(0, rows.reshape(-1),
                              w.sum(dim=2, dtype=torch.int32).reshape(-1))
    return out


def pops_sparse(rows_t, cols_t, radii2, n_valid, ti, tj, rmask, row_block,
                col_block):
    """Row-side multi-radius population counts (replaces
    ``_pops_sparse_kernel``), for tile lists that hold both orientations.

    Each pair of a listed tile with col < n_valid, d2 <= radii2[r] and bit
    r of the tile's ``rmask`` set adds 1 to the ROW frame only. The self
    pair (d2 = 0) counts, so there is no diagonal +1. Entries with tj < 0
    or rmask 0 are no-ops; counts are not idempotent, so the list holds
    each tile at most once. Returns (R, R_pad) int32 counts at the row
    positions of ``rows_t``."""
    _tally("pops_sparse", ti)
    if rows_t.device.type == "cpu":
        return pops_sparse_plain(rows_t, cols_t, radii2, n_valid, ti, tj,
                                 rmask, row_block, col_block)
    n_dim, r_pad = rows_t.shape
    n_pad = cols_t.shape[1]
    n_radii = radii2.shape[0]
    n_tiles = ti.shape[0]
    _check_cuda(rows_t, [
        ("cols_t", cols_t, torch.float32, (n_dim, n_pad)),
        ("radii2", radii2, torch.float32, (n_radii,)),
        ("ti", ti, torch.int32, (n_tiles,)),
        ("tj", tj, torch.int32, (n_tiles,)),
        ("rmask", rmask, torch.int32, (n_tiles,))], [("n_valid", n_valid)])
    _grid(rows_t, cols_t, row_block, col_block)
    _check(1 <= n_radii <= 31, "1 to 31 radii are supported")
    out = torch.zeros((n_radii, r_pad), dtype=torch.int32,
                      device=rows_t.device)
    if n_tiles == 0:
        return out
    with torch.cuda.device(rows_t.device):
        stream = _stream(rows_t.device)
        for g in range(0, n_radii, MAX_RADII_PER_LAUNCH):
            n_g = min(MAX_RADII_PER_LAUNCH, n_radii - g)
            rm_g = ((rmask >> g) & ((1 << n_g) - 1)).contiguous()
            _run("ck_pops_sparse", "pops_sparse", _ptr(rows_t), r_pad,
                 _ptr(cols_t), n_pad, n_dim, _ptr(radii2[g:]), n_g,
                 int(n_valid), _ptr(ti), _ptr(tj), _ptr(rm_g), n_tiles,
                 row_block, col_block, _ptr(out[g:]), stream)
    return out


# -- nearest neighbours --------------------------------------------------------

def nn_keys_init(n_pad, device):
    """A fresh (2, N_pad) [nh; hd] key buffer: every key "no neighbour"."""
    return torch.full((2, n_pad), KEY_NONE, dtype=torch.int64, device=device)


def unpack_keys(keys):
    """(d2 float32, original id int64) of packed keys; KEY_NONE unpacks to
    (inf, INT32_MAX)."""
    hi = (keys >> 32).to(torch.int32)
    return hi.view(torch.float32), keys & 0xFFFFFFFF


def nn_bidir_plain(coords_t, fe, oid, n_valid, ti, tj, keys, row_block,
                   col_block):
    """Plain version of :func:`nn_bidir`."""
    n_pad = coords_t.shape[1]
    pos = torch.arange(n_pad, device=coords_t.device)
    # pads write into their own (unused) slots of the id-indexed buffer
    slot = torch.where(pos < n_valid, oid.long(), pos)
    inf = torch.tensor(float("inf"), device=coords_t.device)
    for rows, cols in _batches(ti, tj, row_block, col_block):
        d2 = _tile_d2(coords_t, rows, coords_t, cols).contiguous()
        ok = ((d2 > 0.0) & (d2 < inf)
              & (rows < n_valid)[:, :, None] & (cols < n_valid)[:, None, :])
        bits = d2.view(torch.int32).long() << 32
        fe_x = fe[rows][:, :, None]
        fe_y = fe[cols][:, None, :]
        k_row = bits | oid[cols].long()[:, None, :]
        k_col = bits | oid[rows].long()[:, :, None]
        for side, gate in ((0, ok), (1, ok & (fe_y < fe_x))):
            best = torch.where(gate, k_row, KEY_NONE).amin(dim=2)
            keys[side].scatter_reduce_(0, slot[rows].reshape(-1),
                                       best.reshape(-1), "amin")
        for side, gate in ((0, ok), (1, ok & (fe_x < fe_y))):
            best = torch.where(gate, k_col, KEY_NONE).amin(dim=1)
            keys[side].scatter_reduce_(0, slot[cols].reshape(-1),
                                       best.reshape(-1), "amin")
    return keys


def nn_bidir(coords_t, fe, oid, n_valid, ti, tj, keys, row_block,
             col_block):
    """Bidirectional joint NN / lower-fe NN sweep (replaces
    ``_nn_bidir_kernel``).

    For every frame of every tile, both the row side and the column side
    fold their candidates into ``keys`` -- a (2, N_pad) int64 [nh; hd]
    buffer of packed (float_bits(d2) << 32) | original_id keys indexed by
    ORIGINAL frame id -- by lexicographic minimum, IN PLACE. Candidates
    need d2 > 0 (finite) and both frames below n_valid; hd needs strictly
    lower fe. ``fe`` (N_pad,) float32 and ``oid`` (N_pad,) int32 are in
    the layout's frame positions. Returns ``keys``."""
    _tally("nn_bidir", ti)
    if coords_t.device.type == "cpu":
        return nn_bidir_plain(coords_t, fe, oid, n_valid, ti, tj, keys,
                              row_block, col_block)
    n_dim, n_pad = coords_t.shape
    n_tiles = ti.shape[0]
    _check_cuda(coords_t, [
        ("fe", fe, torch.float32, (n_pad,)),
        ("oid", oid, torch.int32, (n_pad,)),
        ("ti", ti, torch.int32, (n_tiles,)),
        ("tj", tj, torch.int32, (n_tiles,)),
        ("keys", keys, torch.int64, (2, n_pad))], [("n_valid", n_valid)])
    _grid(coords_t, coords_t, row_block, col_block)
    if n_tiles == 0:
        return keys
    with torch.cuda.device(coords_t.device):
        _run("ck_nn_bidir", "nn_bidir", _ptr(coords_t), n_pad, n_dim,
             _ptr(fe), _ptr(oid), int(n_valid), _ptr(ti), _ptr(tj), n_tiles,
             row_block, col_block, _ptr(keys), _stream(coords_t.device))
    return keys


def nn_sparse_plain(rows_t, fe_rows, oid_rows, cols_t, fe_cols, oid,
                    n_valid, ti, tj, keys, row_block, col_block):
    """Plain version of :func:`nn_sparse`."""
    inf = torch.tensor(float("inf"), device=rows_t.device)
    keep = tj >= 0
    for rows, cols in _batches(ti[keep], tj[keep], row_block, col_block):
        d2 = _tile_d2(rows_t, rows, cols_t, cols).contiguous()
        ok = (d2 > 0.0) & (d2 < inf) & (cols < n_valid)[:, None, :]
        k_row = ((d2.view(torch.int32).long() << 32)
                 | oid[cols].long()[:, None, :])
        slot = oid_rows[rows].long()
        write = slot != IMAX
        lower = fe_cols[cols][:, None, :] < fe_rows[rows][:, :, None]
        for side, gate in ((0, ok), (1, ok & lower)):
            best = torch.where(gate, k_row, KEY_NONE).amin(dim=2)
            keys[side].scatter_reduce_(0, slot[write], best[write], "amin")
    return keys


def nn_sparse(rows_t, fe_rows, oid_rows, cols_t, fe_cols, oid, n_valid, ti,
              tj, keys, row_block, col_block):
    """Row-side joint NN / lower-fe NN sweep (replaces
    ``_nn_sparse_kernel``), for tile lists that hold both orientations.

    A row frame's candidates are the columns below n_valid with
    0 < d2 < inf; hd candidates also need fe_cols < fe_rows. Each row's
    lexicographic (d2, original id) minimum folds IN PLACE into ``keys``,
    the (2, N_pad) int64 id-keyed buffer of :func:`nn_bidir`, at slot
    ``oid_rows[row]`` (below N_pad); rows whose ``oid_rows`` is INT32_MAX
    (pads) never write. ``fe_rows``/``oid_rows`` (R_pad,) belong to
    ``rows_t``, ``fe_cols``/``oid`` (N_pad,) to ``cols_t``. Entries with
    tj < 0 are no-ops and repeats are harmless; the kernel runs the list in
    :func:`wave_order`, and ``keys`` may already hold keys (a first pass's),
    which its rows then start from. Returns ``keys``."""
    _tally("nn_sparse", ti)
    if rows_t.device.type == "cpu":
        return nn_sparse_plain(rows_t, fe_rows, oid_rows, cols_t, fe_cols,
                               oid, n_valid, ti, tj, keys, row_block,
                               col_block)
    n_dim, r_pad = rows_t.shape
    n_pad = cols_t.shape[1]
    n_tiles = ti.shape[0]
    _check_cuda(rows_t, [
        ("fe_rows", fe_rows, torch.float32, (r_pad,)),
        ("oid_rows", oid_rows, torch.int32, (r_pad,)),
        ("cols_t", cols_t, torch.float32, (n_dim, n_pad)),
        ("fe_cols", fe_cols, torch.float32, (n_pad,)),
        ("oid", oid, torch.int32, (n_pad,)),
        ("ti", ti, torch.int32, (n_tiles,)),
        ("tj", tj, torch.int32, (n_tiles,)),
        ("keys", keys, torch.int64, (2, n_pad))], [("n_valid", n_valid)])
    _grid(rows_t, cols_t, row_block, col_block)
    if n_tiles == 0:
        return keys
    perm = wave_order(ti, tj, row_block, col_block, r_pad // row_block,
                      n_pad // col_block)
    ti, tj = ti[perm], tj[perm]
    with torch.cuda.device(rows_t.device):
        _run("ck_nn_sparse", "nn_sparse", _ptr(rows_t), r_pad, _ptr(fe_rows),
             _ptr(oid_rows), _ptr(cols_t), n_pad, n_dim, _ptr(fe_cols),
             _ptr(oid), int(n_valid), _ptr(ti), _ptr(tj), n_tiles,
             row_block, col_block, _ptr(keys), _stream(rows_t.device))
    return keys


# -- screening proposals -------------------------------------------------------

def label_min_bidir_plain(coords_t, labels, n_below, max_dist2, ti, tj,
                          dirty, row_block, col_block):
    """Plain version of :func:`label_min_bidir`."""
    out = labels.clone()
    keep = dirty != 0
    md2 = torch.tensor(np.float32(max_dist2), device=coords_t.device)
    for rows, cols in _batches(ti[keep], tj[keep], row_block, col_block):
        d2 = _tile_d2(coords_t, rows, coords_t, cols)
        adj = ((d2 < md2) & (rows < n_below)[:, :, None]
               & (cols < n_below)[:, None, :])
        row_p = torch.where(adj, labels[cols][:, None, :], IMAX).amin(dim=2)
        col_p = torch.where(adj, labels[rows][:, :, None], IMAX).amin(dim=1)
        out.scatter_reduce_(0, rows.reshape(-1), row_p.reshape(-1), "amin")
        out.scatter_reduce_(0, cols.reshape(-1), col_p.reshape(-1), "amin")
    return out


def label_min_bidir(coords_t, labels, n_below, max_dist2, ti, tj, dirty,
                    row_block, col_block):
    """One bidirectional screening sweep (replaces
    ``_label_min_bidir_kernel``).

    Over the tiles whose ``dirty`` flag is set, every pair with
    d2 < max_dist2 and both positions below n_below proposes each frame's
    label to the other. Returns the swept labels, (N_pad,) int32
    ``min(labels, proposals)``; ``labels`` is left unchanged."""
    _tally("label_min_bidir", ti)
    if coords_t.device.type == "cpu":
        return label_min_bidir_plain(coords_t, labels, n_below, max_dist2,
                                     ti, tj, dirty, row_block, col_block)
    n_dim, n_pad = coords_t.shape
    n_tiles = ti.shape[0]
    _check_cuda(coords_t, [
        ("labels", labels, torch.int32, (n_pad,)),
        ("ti", ti, torch.int32, (n_tiles,)),
        ("tj", tj, torch.int32, (n_tiles,)),
        ("dirty", dirty, torch.int32, (n_tiles,))], [("n_below", n_below)])
    _grid(coords_t, coords_t, row_block, col_block)
    out = labels.clone()
    if n_tiles == 0:
        return out
    with torch.cuda.device(coords_t.device):
        _run("ck_label_min_bidir", "label_min_bidir", _ptr(coords_t), n_pad,
             n_dim, _ptr(labels), int(n_below),
             ctypes.c_float(np.float32(max_dist2)), _ptr(ti), _ptr(tj),
             _ptr(dirty), n_tiles, row_block, col_block, _ptr(out),
             _stream(coords_t.device))
    return out


def label_min_sparse_plain(rows_t, cols_t, labels, n_below, max_dist2, ti,
                           tj, row_block_offset, dirty, row_block,
                           col_block):
    """Plain version of :func:`label_min_sparse`."""
    out = torch.full((rows_t.shape[1],), IMAX, dtype=torch.int32,
                     device=rows_t.device)
    keep = (tj >= 0) & (dirty[tj.clamp_min(0).long()] != 0)
    md2 = torch.tensor(np.float32(max_dist2), device=rows_t.device)
    for rows, cols in _batches(ti[keep], tj[keep], row_block, col_block):
        d2 = _tile_d2(rows_t, rows, cols_t, cols)
        grow = rows + int(row_block_offset) * row_block
        adj = ((d2 < md2) & (grow < n_below)[:, :, None]
               & (cols < n_below)[:, None, :])
        prop = torch.where(adj, labels[cols][:, None, :], IMAX).amin(dim=2)
        out.scatter_reduce_(0, rows.reshape(-1), prop.reshape(-1), "amin")
    return out


def label_min_sparse(rows_t, cols_t, labels, n_below, max_dist2, ti, tj,
                     row_block_offset, dirty, row_block, col_block):
    """Row-side screening proposals (replaces
    ``_label_min_sparse_kernel``), for tile lists that hold both
    orientations.

    ``ti`` indexes row blocks of ``rows_t``, whose first frame is the
    global position ``row_block_offset * row_block``; ``tj`` indexes
    column blocks of ``cols_t``. A tile is swept when its column block is
    dirty (``dirty`` (N_pad // col_block,) int32, indexed by tj); each of
    its pairs with d2 < max_dist2 and both global positions below n_below
    proposes ``labels[col]`` to the row. Returns the (R_pad,) int32
    proposals, INT32_MAX where a row has none; ``labels`` (N_pad,) is left
    unchanged. Entries with tj < 0 are no-ops and repeats are harmless;
    the kernel runs the list in :func:`wave_order`."""
    _tally("label_min_sparse", ti)
    if rows_t.device.type == "cpu":
        return label_min_sparse_plain(rows_t, cols_t, labels, n_below,
                                      max_dist2, ti, tj, row_block_offset,
                                      dirty, row_block, col_block)
    n_dim, r_pad = rows_t.shape
    n_pad = cols_t.shape[1]
    n_tiles = ti.shape[0]
    _check_cuda(rows_t, [
        ("cols_t", cols_t, torch.float32, (n_dim, n_pad)),
        ("labels", labels, torch.int32, (n_pad,)),
        ("ti", ti, torch.int32, (n_tiles,)),
        ("tj", tj, torch.int32, (n_tiles,)),
        ("dirty", dirty, torch.int32, (n_pad // col_block,))],
        [("n_below", n_below), ("row_block_offset", row_block_offset)])
    _grid(rows_t, cols_t, row_block, col_block)
    out = torch.full((r_pad,), IMAX, dtype=torch.int32, device=rows_t.device)
    if n_tiles == 0:
        return out
    perm = wave_order(ti, tj, row_block, col_block, r_pad // row_block,
                      n_pad // col_block, row_block_offset)
    ti, tj = ti[perm], tj[perm]
    with torch.cuda.device(rows_t.device):
        _run("ck_label_min_sparse", "label_min_sparse", _ptr(rows_t), r_pad,
             _ptr(cols_t), n_pad, n_dim, _ptr(labels), int(n_below),
             ctypes.c_float(np.float32(max_dist2)), _ptr(ti), _ptr(tj),
             int(row_block_offset), _ptr(dirty), n_tiles, row_block,
             col_block, _ptr(out), _stream(rows_t.device))
    return out


# -- dense skip-word grids -----------------------------------------------------

def kept_tiles(skip_words, n_row_blocks, n_col_blocks):
    """Row-major (ti, tj) int32 lists of the grid cells whose skip bit is
    clear: bit j of row block i is bit j % 32 of word
    i * ceil(n_col_blocks / 32) + j // 32 (:func:`.pruning.pack_skip_words`)."""
    words_per_row = -(-n_col_blocks // 32)
    w = skip_words.reshape(n_row_blocks, words_per_row, 1)
    bits = (w >> torch.arange(32, dtype=torch.int32, device=w.device)) & 1
    skip = bits.reshape(n_row_blocks, words_per_row * 32)[:, :n_col_blocks]
    ti, tj = torch.nonzero(skip == 0, as_tuple=True)
    return ti.to(torch.int32), tj.to(torch.int32)


def pops_tiles_cross_plain(rows_t, cols_t, radii2, n_valid, skip_words,
                           row_block=DEFAULT_ROW_BLOCK,
                           col_block=DEFAULT_COL_BLOCK):
    """Plain version of :func:`pops_tiles_cross`: the kept cells through
    :func:`pops_sparse_plain` with every radius bit set."""
    ti, tj = kept_tiles(skip_words, rows_t.shape[1] // row_block,
                        cols_t.shape[1] // col_block)
    return pops_sparse_plain(rows_t, cols_t, radii2, n_valid, ti, tj,
                             torch.full_like(ti, -1), row_block, col_block)


def pops_tiles_cross(rows_t, cols_t, radii2, n_valid, skip_words,
                     row_block=DEFAULT_ROW_BLOCK,
                     col_block=DEFAULT_COL_BLOCK):
    """Multi-radius population counts of the ``rows_t`` frames against the
    ``cols_t`` frames over the dense (R_pad / row_block, N_pad / col_block)
    grid (replaces ``_pops_kernel``).

    A cell is skipped iff its bit is set in ``skip_words``, the flat int32
    words of :func:`.pruning.pack_skip_words`. Every pair of a kept cell
    with col < n_valid and d2 <= radii2[r] adds 1 to the ROW frame's count
    at radius r; the self pair counts (d2 = 0). Returns (R, R_pad) int32
    counts in the row order of ``rows_t``, 0 where every cell of a row
    block is skipped."""
    if rows_t.device.type == "cpu":
        return pops_tiles_cross_plain(rows_t, cols_t, radii2, n_valid,
                                      skip_words, row_block, col_block)
    n_dim, r_pad = rows_t.shape
    n_pad = cols_t.shape[1]
    n_radii = radii2.shape[0]
    words_per_row = -(-(n_pad // col_block) // 32)
    _check_cuda(rows_t, [
        ("cols_t", cols_t, torch.float32, (n_dim, n_pad)),
        ("radii2", radii2, torch.float32, (n_radii,)),
        ("skip_words", skip_words, torch.int32,
         ((r_pad // row_block) * words_per_row,))], [("n_valid", n_valid)])
    _grid(rows_t, cols_t, row_block, col_block)
    _check(1 <= n_radii <= 31, "1 to 31 radii are supported")
    out = torch.zeros((n_radii, r_pad), dtype=torch.int32,
                      device=rows_t.device)
    if r_pad == 0 or n_pad == 0:
        return out
    with torch.cuda.device(rows_t.device):
        stream = _stream(rows_t.device)
        for g in range(0, n_radii, MAX_RADII_PER_LAUNCH):
            n_g = min(MAX_RADII_PER_LAUNCH, n_radii - g)
            _run("ck_pops_tiles", "pops_tiles", _ptr(rows_t), r_pad,
                 _ptr(cols_t), n_pad, n_dim, _ptr(radii2[g:]), n_g,
                 int(n_valid), _ptr(skip_words), words_per_row, row_block,
                 col_block, _ptr(out[g:]), stream)
    return out


def pops_tiles(coords_t, radii2, n_valid, skip_words,
               row_block=DEFAULT_ROW_BLOCK, col_block=DEFAULT_COL_BLOCK):
    """All-pairs population counts of one frame matrix; see
    :func:`pops_tiles_cross`."""
    return pops_tiles_cross(coords_t, coords_t, radii2, n_valid, skip_words,
                            row_block, col_block)


def _row_results(keys):
    """(nh_d, nh_j, hd_d, hd_j), each (1, R_pad), of a (2, R_pad) key
    buffer in row position; KEY_NONE gives (+inf, INT32_MAX)."""
    d2, ids = unpack_keys(keys)
    ids = ids.to(torch.int32)
    return d2[0:1], ids[0:1], d2[1:2], ids[1:2]


def nn_tiles_cross_plain(rows_t, fe_rows, cols_t, fe_cols, orig_ids,
                         n_valid, skip_words, row_block=DEFAULT_ROW_BLOCK,
                         col_block=DEFAULT_COL_BLOCK):
    """Plain version of :func:`nn_tiles_cross`: the kept cells through
    :func:`nn_sparse_plain`, keyed by row position."""
    r_pad = rows_t.shape[1]
    ti, tj = kept_tiles(skip_words, r_pad // row_block,
                        cols_t.shape[1] // col_block)
    keys = nn_keys_init(r_pad, rows_t.device)
    pos = torch.arange(r_pad, dtype=torch.int32, device=rows_t.device)
    nn_sparse_plain(rows_t, fe_rows.reshape(-1), pos, cols_t,
                    fe_cols.reshape(-1), orig_ids.reshape(-1), n_valid, ti,
                    tj, keys, row_block, col_block)
    return _row_results(keys)


def nn_tiles_cross(rows_t, fe_rows, cols_t, fe_cols, orig_ids, n_valid,
                   skip_words, row_block=DEFAULT_ROW_BLOCK,
                   col_block=DEFAULT_COL_BLOCK):
    """Joint NN / lower-fe NN search of the ``rows_t`` frames against the
    ``cols_t`` frames over the dense (R_pad / row_block, N_pad / col_block)
    grid (replaces ``_nn_kernel``).

    A cell is skipped iff its bit is set in ``skip_words``. A row's
    candidates in a kept cell are the columns below n_valid with
    0 < d2 < inf; hd candidates also need fe_cols < fe_rows. ``fe_rows``
    (1, R_pad) float32 belongs to ``rows_t``; ``fe_cols`` (1, N_pad)
    float32 (+inf on pads) and ``orig_ids`` (1, N_pad) int32 to ``cols_t``.
    Ties break toward the smaller original id. Returns (nh_d, nh_j, hd_d,
    hd_j), each (1, R_pad) in the ROW order of ``rows_t``: float32 d2 and
    int32 original ids, (+inf, INT32_MAX) where the kept cells held no
    admissible neighbour (callers combine passes accordingly)."""
    if rows_t.device.type == "cpu":
        return nn_tiles_cross_plain(rows_t, fe_rows, cols_t, fe_cols,
                                    orig_ids, n_valid, skip_words,
                                    row_block, col_block)
    n_dim, r_pad = rows_t.shape
    n_pad = cols_t.shape[1]
    words_per_row = -(-(n_pad // col_block) // 32)
    _check_cuda(rows_t, [
        ("fe_rows", fe_rows, torch.float32, (1, r_pad)),
        ("cols_t", cols_t, torch.float32, (n_dim, n_pad)),
        ("fe_cols", fe_cols, torch.float32, (1, n_pad)),
        ("orig_ids", orig_ids, torch.int32, (1, n_pad)),
        ("skip_words", skip_words, torch.int32,
         ((r_pad // row_block) * words_per_row,))], [("n_valid", n_valid)])
    _grid(rows_t, cols_t, row_block, col_block)
    keys = nn_keys_init(r_pad, rows_t.device)
    if r_pad == 0 or n_pad == 0:
        return _row_results(keys)
    with torch.cuda.device(rows_t.device):
        _run("ck_nn_tiles", "nn_tiles", _ptr(rows_t), r_pad, _ptr(fe_rows),
             _ptr(cols_t), n_pad, n_dim, _ptr(fe_cols), _ptr(orig_ids),
             int(n_valid), _ptr(skip_words), words_per_row, row_block,
             col_block, _ptr(keys), _stream(rows_t.device))
    return _row_results(keys)


def nn_tiles(coords_t, fe, orig_ids, n_valid, skip_words,
             row_block=DEFAULT_ROW_BLOCK, col_block=DEFAULT_COL_BLOCK):
    """All-pairs NN search of one frame matrix; see
    :func:`nn_tiles_cross`."""
    return nn_tiles_cross(coords_t, fe, coords_t, fe, orig_ids, n_valid,
                          skip_words, row_block, col_block)
