"""Block-level spatial pruning for the pairwise tile sweeps.

Counterpart of ``clustering_tpu/ops/pruning.py``. The numpy planners are
copies of the JAX package's, so the port's frame orders, masks and tile
sets equal the reference's; the block bounding-box distances are computed
on the device as plain torch ops. Masks stay bool arrays and tile lists
are flat: the chunking, power-of-two buckets and pads of the JAX package
exist only for XLA compile shapes and TPU scalar memory. The dense-grid
kernels take their mask as the JAX package's bit-packed skip words.

Device planning (the ``*_device`` functions): the same masks as torch
ops on the tensors' device, and :func:`tile_list_device` compacts them
there, so no (nrb, ncb) plane crosses to the host; the only host traffic
is the tile count. They emit the numpy planners' tile sets in the same
row-major order. On a mesh each device plans only the row blocks dealt
to it (``rows``: ``(start, step)``, the blocks ``start, start + step,
...``): :func:`bbox_d2`, :func:`band_mask_device`,
:func:`upper_tri_device` and :func:`tile_list_device` take the deal and
keep global block indices, and :func:`group_rows_device` and
:func:`closure_rows_device` close a bidirectional mask whose rows lie
on several devices. No device then holds more than ``ceil(nrb / S)``
rows of any block-pair matrix; the planners count each matrix they
allocate on the open ``mesh.plan`` span (``rows_max``,
``matrix_bytes_max``). The engines plan every stage with them, on both
routes and at every N: the JAX package gates them at 2^22 padded frames,
but on the card no size has shown the host plan faster
(``chip_smoke.py`` times both planners on the same masks at 2^20 and
2^24). The numpy planners
(:func:`threshold_planes`, :func:`tile_list`, :func:`band_mask`,
:func:`bidir_closure`, :func:`upper_mask`) stay as the reference the
tests hold the device planners and the JAX package against; no engine
stage calls them, and only the skip-word planners of the dense-grid
library functions plan on the host. The density engine's layout orders
are sorted on its device as well (:func:`dim0_order_device`,
:func:`morton_order_device`, element for element the host sorts);
:func:`morton_order` stays their reference and the screener's order when
none is handed in. Not ported from the JAX package:

- ``window_counts_device`` and the column windows of
  ``tile_list_device``: windows bound the Pallas kernels' VMEM
  accumulators (``POPS_BIDIR_SCRATCH_CAP``, ``NN_BIDIR_SCRATCH_CAP``,
  ``BIDIR_UNION_VMEM``); the CUDA kernels fold through global atomics
  over one flat list;
- the chunk buckets and ``quantize_chunks`` of ``_tile_list_dev_call``:
  they exist for XLA's static shapes, and so do the lists' pads;
- ``act_rows_bool_device``: one comparison, inlined in the engine;
- ``tile_list_device_split`` and ``split_tiles_balanced``: the device
  list dealt over the mesh, padded to a common XLA shape; here each
  device plans the list of its own row blocks;
- ``iter_col_windows``: the column windows, for the reason above.

Pruning is exact: a tile is skipped only when its bounding-box distance
lower bound exceeds the threshold.
"""

import numpy as np
import torch

from ..utils import textio_native
from ..utils.timer import count_max

# the span that a mesh's per-device planning opens (``parallel.mesh``)
PLAN_SPAN = "mesh.plan"


def morton_order(coords):
    """Frame order along a Morton (Z-order) curve; the native pass when
    the library loads (bit-identical), numpy otherwise. Coordinates are
    cast to float32 first in both paths."""
    c32 = np.ascontiguousarray(coords, dtype=np.float32)
    native = textio_native.morton_order_pad(c32)
    if native is not None:
        return native
    c = c32.astype(np.float64)
    n, d = c.shape
    bits = max(1, 62 // d)
    lo = c.min(axis=0)
    span = c.max(axis=0) - lo
    span[span == 0] = 1.0
    q = ((c - lo) / span * ((1 << bits) - 1)).astype(np.uint64)
    key = np.zeros(n, dtype=np.uint64)
    for b in range(bits):
        for k in range(d):
            key |= ((q[:, k] >> np.uint64(b)) & np.uint64(1)) \
                << np.uint64(b * d + k)
    return np.argsort(key, kind="stable")


def dim0_order_device(frames):
    """The dim0 layout's frame order of the (N, D) float32 tensor
    ``frames``, on its device: the stable argsort of the first coordinate,
    ``np.argsort(frames[:, 0], kind="stable")`` element for element. The
    key is canonicalised so that -0.0 and +0.0 tie, as numpy compares
    them (a radix sort would order them by their sign bit)."""
    x = frames[:, 0]
    return torch.argsort(torch.where(x == 0, 0.0, x), stable=True)


def _byte_spread(d, bits):
    """(256,) int64: each byte value with its bit i moved to bit i * d,
    for the bits i < min(8, bits) that a quantised coordinate holds."""
    return [sum(((v >> i) & 1) << (i * d) for i in range(min(8, bits)))
            for v in range(256)]


def morton_order_device(frames):
    """The Morton layout's frame order of the (N, D) float32 tensor
    ``frames``, on its device: :func:`morton_order`'s keys step for step
    (float64 quantisation truncated to an integer, bit ``b`` of coordinate
    ``k`` at ``b * D + k``, bits at 64 and above dropped as numpy's uint64
    shifts drop them), stably sorted, so the order is
    :func:`morton_order`'s element for element. One coordinate at a time,
    each byte of it spread by a table: a few dozen ops whatever N, and no
    temporary larger than one (N,) column of float64."""
    n, d = frames.shape
    dev = frames.device
    bits = max(1, 62 // d)
    lo = frames.amin(dim=0).double()
    span = frames.amax(dim=0).double() - lo
    span = torch.where(span == 0, 1.0, span)
    scale = float((1 << bits) - 1)
    spread = torch.tensor(_byte_spread(d, bits), dtype=torch.int64,
                          device=dev)
    imin = torch.iinfo(torch.int64).min
    keys = torch.zeros(n, dtype=torch.int64, device=dev)
    for k in range(min(d, 64)):
        q = frames[:, k].double().sub_(lo[k]).div_(span[k]).mul_(scale)
        q = q.long().bitwise_and_((1 << bits) - 1)
        for j in range(0, bits, 8):
            part = spread[(q >> j).bitwise_and_(255)]
            shift = j * d + k
            # bit 63 is the sign bit: the flip below makes the int64
            # order of the keys their uint64 order
            keys.bitwise_or_(part.bitwise_left_shift_(shift) if shift < 63
                             else part.mul_(imin))
    return torch.argsort(keys.bitwise_xor_(imin), stable=True)


def block_bboxes(coords, block):
    """Per-block per-dimension (mins, maxs); coords (N_pad, D) with N_pad a
    multiple of block."""
    c = np.asarray(coords)
    n, d = c.shape
    blocks = c.reshape(n // block, block, d)
    return blocks.min(axis=1), blocks.max(axis=1)


_BBOX_ROW_CHUNK = 16384


def bbox_dist2(row_mins, row_maxs, col_mins, col_maxs):
    """(n_row_blocks, n_col_blocks) float32 lower bounds on the squared
    distance between any row-block frame and any col-block frame, scaled
    downward so fp32 rounding never lifts a bound past a threshold."""
    nrb, ncb = row_mins.shape[0], col_mins.shape[0]
    n_dim = row_mins.shape[1]
    rmin_d = [np.ascontiguousarray(row_mins[:, k], dtype=np.float32)
              for k in range(n_dim)]
    rmax_d = [np.ascontiguousarray(row_maxs[:, k], dtype=np.float32)
              for k in range(n_dim)]
    cmin_d = [np.ascontiguousarray(col_mins[:, k], dtype=np.float32)
              for k in range(n_dim)]
    cmax_d = [np.ascontiguousarray(col_maxs[:, k], dtype=np.float32)
              for k in range(n_dim)]
    margin = np.float32(1.0 - (n_dim + 8) * 2.0 ** -23)
    big = np.float32(np.finfo(np.float32).max) * margin
    out = np.empty((nrb, ncb), dtype=np.float32)
    with np.errstate(over="ignore"):
        for lo in range(0, nrb, _BBOX_ROW_CHUNK):
            hi = min(lo + _BBOX_ROW_CHUNK, nrb)
            acc = np.zeros((hi - lo, ncb), dtype=np.float32)
            gap = np.empty((hi - lo, ncb), dtype=np.float32)
            g2 = np.empty((hi - lo, ncb), dtype=np.float32)
            for k in range(n_dim):
                np.subtract(rmin_d[k][lo:hi, None], cmax_d[k][None, :],
                            out=gap)
                np.subtract(cmin_d[k][None, :], rmax_d[k][lo:hi, None],
                            out=g2)
                np.maximum(gap, g2, out=gap)
                np.maximum(gap, np.float32(0.0), out=gap)
                np.multiply(gap, gap, out=gap)
                acc += gap
            # padded blocks at 3e38 overflow to +inf: exactly "far"
            np.minimum(acc, big, out=acc)
            acc *= margin
            out[lo:hi] = acc
    return out


def deal_rows(n_rows, rows):
    """How many of ``n_rows`` row blocks the deal ``rows`` ((start, step);
    None: all) holds."""
    return n_rows if rows is None else len(range(rows[0], n_rows, rows[1]))


def row_ids(n_dealt, rows, device):
    """(n_dealt, 1) int64 global indices of the rows of a matrix over the
    deal ``rows`` (None: 0 .. n_dealt - 1)."""
    ri = torch.arange(n_dealt, device=device)[:, None]
    return ri if rows is None else ri * rows[1] + rows[0]


def dealt(t, rows):
    """The entries of the per-row-block tensor ``t`` that the deal ``rows``
    holds (a view; ``t`` itself for None)."""
    return t if rows is None else t[rows[0]::rows[1]]


def _allocated(matrix):
    """Count a block-pair matrix (or a stack of them) on the open
    ``mesh.plan`` span: its rows (``rows_max``) and bytes
    (``matrix_bytes_max``); nothing without one."""
    count_max("rows_max", matrix.shape[-2], within=PLAN_SPAN)
    count_max("matrix_bytes_max", matrix.numel() * matrix.element_size(),
              within=PLAN_SPAN)
    return matrix


def bbox_d2(coords_t, row_block, col_block, cols_t=None, rows=None):
    """Device counterpart of ``bbox_dist2`` from the (D, N_pad) frame
    matrix: the same per-dimension gap accumulation and downward margin,
    as plain torch ops on the matrix's device. ``cols_t`` (D, M_pad), if
    given, supplies the column blocks (rows stay ``coords_t``'s);
    ``rows`` ((start, step)) keeps only the row blocks of that deal, in
    order, so that the matrix has one row per dealt block."""
    cols_t = coords_t if cols_t is None else cols_t
    n_dim = coords_t.shape[0]
    rblk = coords_t.reshape(n_dim, -1, row_block)
    rmin, rmax = rblk.amin(dim=2), rblk.amax(dim=2)
    if rows is not None:
        rmin, rmax = rmin[:, rows[0]::rows[1]], rmax[:, rows[0]::rows[1]]
    cblk = cols_t.reshape(n_dim, -1, col_block)
    cmin, cmax = cblk.amin(dim=2), cblk.amax(dim=2)
    margin = np.float32(1.0 - (n_dim + 8) * 2.0 ** -23)
    big = float(np.float32(np.finfo(np.float32).max) * margin)
    acc = torch.zeros((rmin.shape[1], cmin.shape[1]),
                      dtype=torch.float32, device=coords_t.device)
    for k in range(n_dim):
        gap = torch.maximum(rmin[k][:, None] - cmax[k][None, :],
                            cmin[k][None, :] - rmax[k][:, None])
        gap = gap.clamp_min(0.0)
        acc = acc + gap * gap
    return _allocated(torch.clamp(acc, max=big) * float(margin))


def le_planes_device(d2b, thresh2s, strict=False):
    """(T, nrb, ncb) bool planes of d2b <= thresh2s[t] (strict <) on
    d2b's device."""
    t = torch.tensor(np.asarray(thresh2s, dtype=np.float32),
                     device=d2b.device)[:, None, None]
    return _allocated(d2b[None] < t if strict else d2b[None] <= t)


def le_rows_device(d2b, bound):
    """(nrb, ncb) bool plane of d2b <= ``bound`` of its row block (one
    per row of d2b, on its device)."""
    return _allocated(d2b <= bound[:, None])


def threshold_planes(d2b, thresh2s, strict=False):
    """:func:`le_planes_device` downloaded: (T, nrb, ncb) host bool
    planes (a reference: no stage calls it)."""
    return le_planes_device(d2b, thresh2s, strict).cpu().numpy()


def bidir_closure(active, row_block, col_block):
    """Upper-triangular closure of an active-tile set for bidirectional
    sweeps: tiles ``upper AND (A OR M)``, where M marks the mirrors of
    active tiles (coarsened to col-block granularity). Every ordered pair
    demanded by ``active`` is evaluated by exactly one kept tile. The
    reference of :func:`bidir_closure_device`: no stage calls it."""
    nrb, ncb = active.shape
    if col_block % row_block != 0:
        raise ValueError("bidir_closure needs col_block % row_block == 0")
    span = col_block // row_block
    assert nrb == ncb * span
    B = active.reshape(ncb, span, ncb).any(axis=1)
    ri = np.arange(nrb)[:, None]
    cj = np.arange(ncb)[None, :]
    mirror = B[cj, ri // span]
    upper = (cj + 1) * col_block > ri * row_block
    return (active | mirror) & upper


def upper_mask(nrb, ncb, row_block, col_block):
    """Tiles that intersect the strict upper triangle (the reference of
    :func:`upper_tri_device`: no stage calls it)."""
    ri = np.arange(nrb)[:, None]
    cj = np.arange(ncb)[None, :]
    return (cj + 1) * col_block > ri * row_block


def band_mask(n_row_blocks, n_col_blocks, row_block, col_block, half_width):
    """Keep-matrix for a diagonal band of +-half_width frames (the NN
    bounding pass): the reference of :func:`band_mask_device`, which the
    engine plans with, and the band of :func:`band_skip_words`."""
    row_centers = (np.arange(n_row_blocks) + 0.5) * row_block
    col_lo = (np.arange(n_col_blocks)) * col_block
    col_hi = col_lo + col_block
    return ((col_hi[None, :] >= row_centers[:, None] - half_width)
            & (col_lo[None, :] <= row_centers[:, None] + half_width))


# -- device planning -----------------------------------------------------------

def upper_tri_device(active, row_block, col_block, rows=None):
    """``active`` restricted to the tiles that intersect the strict upper
    triangle (:func:`upper_mask`), on its device; ``rows``: the deal of
    row blocks that ``active``'s rows are (None: all of them)."""
    ri = row_ids(active.shape[0], rows, active.device)
    cj = torch.arange(active.shape[1], device=active.device)[None, :]
    return active & ((cj + 1) * col_block > ri * row_block)


def bidir_closure_device(active, row_block, col_block):
    """:func:`bidir_closure` of a bool tensor, on its device: the mirror
    ``B[cj, ri // span]`` is ``B.T`` with each row repeated span times."""
    nrb, ncb = active.shape
    if col_block % row_block != 0:
        raise ValueError("bidir_closure needs col_block % row_block == 0")
    span = col_block // row_block
    if nrb != ncb * span:
        raise ValueError(f"a ({nrb}, {ncb}) mask is not square in frames")
    B = active.reshape(ncb, span, ncb).any(dim=1)
    mirror = B.T.repeat_interleave(span, dim=0)
    return upper_tri_device(active | mirror, row_block, col_block)


def group_rows_device(active, rows, row_block, col_block):
    """The part of :func:`bidir_closure_device`'s ``B`` that the rows of
    ``active`` (the deal ``rows`` of the row blocks) hold: (ncb, ncb)
    uint8, entry (g, c) 1 iff a dealt row block of column block g's span
    is active at column block c. Summed over the deals of a mesh, it is
    non-zero where ``B`` is true."""
    ncb = active.shape[1]
    span = col_block // row_block
    if col_block % row_block != 0:
        raise ValueError("bidir_closure needs col_block % row_block == 0")
    # a column block's span of row blocks, counted per deal: at most span
    wide = torch.uint8 if span < 256 else torch.int32
    part = torch.zeros((ncb, ncb), dtype=wide, device=active.device)
    grp = row_ids(active.shape[0], rows, active.device)[:, 0] // span
    part.index_add_(0, grp, active.to(wide) if wide != torch.uint8
                    else active.view(torch.uint8))
    return part.clamp_(max=1).to(torch.uint8)


def closure_rows_device(active, groups, rows, row_block, col_block):
    """:func:`bidir_closure_device` of a mask whose rows lie on several
    devices, for the rows of ``active`` (the deal ``rows``): ``groups``
    is its ``B``, the (ncb, ncb) bool tensor where the sum of every
    deal's :func:`group_rows_device` is non-zero, on ``active``'s device.
    Row block ri's mirror at column block c is ``B[c, ri // span]``."""
    span = col_block // row_block
    grp = row_ids(active.shape[0], rows, active.device)[:, 0] // span
    mirror = _allocated(groups.T[grp])
    return upper_tri_device(active | mirror, row_block, col_block, rows)


def band_mask_device(n_row_blocks, n_col_blocks, row_block, col_block,
                     half_width, device, rows=None):
    """:func:`band_mask` on ``device``, its float comparison doubled into
    exact int64 arithmetic so that it equals the host mask at any N;
    ``rows`` keeps the row blocks of that deal."""
    ri = row_ids(deal_rows(n_row_blocks, rows), rows, device)[:, 0]
    rc2 = (2 * ri + 1) * row_block
    col_lo2 = 2 * torch.arange(n_col_blocks, device=device) * col_block
    col_hi2 = col_lo2 + 2 * col_block
    hw2 = 2 * half_width
    return _allocated((col_hi2[None, :] >= rc2[:, None] - hw2)
                      & (col_lo2[None, :] <= rc2[:, None] + hw2))


def rmask_gather_device(planes, ti, tj):
    """Per-tile radius masks of a flat tile list from (R, nrb, ncb) bool
    planes: bit r set iff tile (ti, tj) is admissible at radius r; int32."""
    bits = planes[:, ti.long(), tj.long()].to(torch.int32)
    weights = torch.tensor([1 << r for r in range(planes.shape[0])],
                           dtype=torch.int32, device=planes.device)
    return (bits * weights[:, None]).sum(dim=0, dtype=torch.int32)


def mask_bits(rmask, n_radii):
    """The (tile, radius) pairs that per-tile radius masks admit: the bits
    set in ``rmask`` summed over its tiles, as a 0-d int64 tensor on its
    device (no host sync)."""
    return sum(((rmask >> r) & 1).sum(dtype=torch.int64)
               for r in range(n_radii))


def tile_list_device(active, rows=None):
    """:func:`tile_list` of a bool tensor, on its device: row-major flat
    (ti, tj) int32 tensors, or None when nothing is active. The count is
    its one host sync. ``rows``: the deal of row blocks that ``active``'s
    rows are, whose global indices ``ti`` then holds (None: all)."""
    nz = torch.nonzero(_allocated(active))
    if nz.shape[0] == 0:
        return None
    tiles = nz.T.to(torch.int32).contiguous()
    if rows is not None:
        tiles[0].mul_(rows[1]).add_(rows[0])
    return tiles[0], tiles[1]


def local_rows(ti, rows):
    """Global row block indices ``ti`` of a deal's list as rows of its
    matrices (the deal ``rows``; ``ti`` itself for None)."""
    return ti if rows is None else (ti - rows[0]) // rows[1]


# -- skip words of the dense-grid kernels (kernels.pops_tiles, nn_tiles) -----
#
# Bit j of row block i is bit j % 32 of word i * words_per_row + j // 32
# (bit 31 makes the word negative); a set bit skips the tile.

WORD_BITS = 32


def pack_skip_words(skip_bool):
    """Pack a (n_row_blocks, n_col_blocks) boolean skip matrix into flat
    int32 words, ``words_per_row`` words per row block; returns (words,
    words_per_row)."""
    nrb, ncb = skip_bool.shape
    words_per_row = -(-ncb // WORD_BITS)
    padded = np.zeros((nrb, words_per_row * WORD_BITS), dtype=bool)
    padded[:, :ncb] = skip_bool
    bits = padded.reshape(nrb, words_per_row, WORD_BITS)
    weights = (1 << np.arange(WORD_BITS, dtype=np.uint64))
    words = (bits.astype(np.uint64) * weights).sum(axis=2)
    return words.astype(np.uint32).view(np.int32).reshape(-1), words_per_row


def no_skip_words(n_row_blocks, n_col_blocks):
    words_per_row = -(-n_col_blocks // WORD_BITS)
    return (np.zeros(n_row_blocks * words_per_row, dtype=np.int32),
            words_per_row)


def radius_skip_words(coords_padded, row_block, col_block, thresh2,
                      strict=True):
    """Skip tile (i, j) iff its bbox distance > thresh2 (>= with
    strict=False, for a strict '<' adjacency)."""
    rmin, rmax = block_bboxes(coords_padded, row_block)
    cmin, cmax = block_bboxes(coords_padded, col_block)
    d2 = bbox_dist2(rmin, rmax, cmin, cmax)
    skip = d2 > thresh2 if strict else d2 >= thresh2
    return pack_skip_words(skip)


def band_skip_words(n_row_blocks, n_col_blocks, row_block, col_block,
                    half_width):
    """Skip everything except the diagonal band of ``band_mask``."""
    return pack_skip_words(~band_mask(n_row_blocks, n_col_blocks,
                                      row_block, col_block, half_width))


def ub_skip_words(coords_padded, row_block, col_block, row_ub):
    """Skip tile (i, j) iff its bbox distance strictly exceeds the row
    block's upper bound ``row_ub[i]`` (+inf keeps the whole row block)."""
    rmin, rmax = block_bboxes(coords_padded, row_block)
    cmin, cmax = block_bboxes(coords_padded, col_block)
    d2 = bbox_dist2(rmin, rmax, cmin, cmax)
    skip = d2 > np.asarray(row_ub, dtype=np.float32)[:, None]
    return pack_skip_words(skip)


def tile_list(active):
    """Row-major flat (ti, tj) int32 lists of the active tiles, or None
    when nothing is active (the reference of :func:`tile_list_device`: no
    stage calls it)."""
    ti, tj = np.nonzero(active)
    if len(ti) == 0:
        return None
    return ti.astype(np.int32), tj.astype(np.int32)
