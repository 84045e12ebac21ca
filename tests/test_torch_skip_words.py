"""The port's dense skip-word route against the JAX package: the five
skip-word planners, ``pops_tiles[_cross]`` and ``nn_tiles[_cross]`` against
the Pallas kernels run in interpret mode, and the slice as a whole -- a
radius-pruned count and a two-phase NN search (a band pass, then a pass
pruned by the band's bounds) composed as the JAX docstrings leave it to
callers.

On the CPU the wrappers take their plain versions, so these tests pin the
plain versions -- the oracles the CUDA kernels are held to -- to the
reference kernels. Counts and ids must be exact and distances bit-equal
(both sides compute the plain fma chain acc = fma(d_k, d_k, acc) from
zero); the only tolerance, 1 ulp, is against the JAX engine, which
recomputes its distances with XLA's arithmetic (ROADMAP.md, "Distance
arithmetic"). The tests marked ``cuda`` hold the two CUDA kernels to their
plain versions on the card and skip without one.
"""

import numpy as np
import pytest
import torch

from clustering_tpu.ops import density as jdops
from clustering_tpu.ops import engine as jengine
from clustering_tpu.ops import pallas_kernels as pk
from clustering_tpu.ops import pruning as jpruning
from clustering_tpu_torch.ops import density as tdops
from clustering_tpu_torch.ops import kernels
from clustering_tpu_torch.ops import neighbors as tnops
from clustering_tpu_torch.ops import pruning as tpruning
from clustering_tpu_torch.ops.engine import NN_BAND_BLOCKS
from clustering_tpu_torch.ops.pairwise import sq_dists

IMAX = np.iinfo(np.int32).max
BLOCKS = [(8, 16), (16, 24)]  # the second pair does not divide
PAD = np.float32(3e38)


def _blobs(n, d, seed, dup=0):
    """Two gaussian blobs, shuffled; the last ``dup`` frames repeat frame
    0 exactly (d2 == 0 is never a neighbour)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0.0, 0.15, size=(n // 2, d))
    b = rng.normal(1.2, 0.2, size=(n - n // 2, d))
    c = np.concatenate([a, b])[rng.permutation(n)].astype(np.float32)
    if dup:
        c[-dup:] = c[0]
    return c


def _morton(c):
    """Frames in Morton order, as the pruned callers lay them out."""
    return c[tpruning.morton_order(c)]


def _pad(c, block):
    """(N_pad, D) with pads at 3e38, N_pad a multiple of ``block``."""
    n_pad = -(-len(c) // block) * block
    out = np.full((n_pad, c.shape[1]), PAD, np.float32)
    out[:len(c)] = c
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# -- planners -------------------------------------------------------------------

@pytest.mark.parametrize("rb,cb", BLOCKS)
def test_skip_word_planners_equal_reference(rb, cb):
    # ncb above 32 and not a multiple of it: 44 (8, 16) and 34 (16, 24)
    coords = _pad(_morton(_blobs(800, 3, seed=rb)), int(np.lcm(rb, cb)))
    nrb, ncb = len(coords) // rb, len(coords) // cb
    assert ncb > 32 and ncb % 32
    rng = np.random.default_rng(cb)
    skip = rng.random((nrb, ncb)) < 0.5
    skip[:, 31] = True  # bit 31: the word is negative

    def same(got, want):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == np.int32 and got[1] == want[1]
        return got[0]

    words = same(tpruning.pack_skip_words(skip),
                 jpruning.pack_skip_words(skip))
    assert (words < 0).any()
    same(tpruning.no_skip_words(nrb, ncb), jpruning.no_skip_words(nrb, ncb))
    # a threshold equal to a bound tells strict from non-strict
    rmin, rmax = tpruning.block_bboxes(coords, rb)
    cmin, cmax = tpruning.block_bboxes(coords, cb)
    d2b = tpruning.bbox_dist2(rmin, rmax, cmin, cmax)
    edge = np.float32(np.sort(d2b[d2b > 0])[0])
    for thresh2 in (np.float32(0.04), edge):
        for strict in (True, False):
            same(tpruning.radius_skip_words(coords, rb, cb, thresh2, strict),
                 jpruning.radius_skip_words(coords, rb, cb, thresh2, strict))
    assert not np.array_equal(
        tpruning.radius_skip_words(coords, rb, cb, edge, True)[0],
        tpruning.radius_skip_words(coords, rb, cb, edge, False)[0])
    for hw in (cb, NN_BAND_BLOCKS * cb):
        same(tpruning.band_skip_words(nrb, ncb, rb, cb, hw),
             jpruning.band_skip_words(nrb, ncb, rb, cb, hw))
    row_ub = rng.random(nrb).astype(np.float32) * np.float32(0.3)
    row_ub[::5] = np.inf  # +inf keeps the whole row block
    ub = same(tpruning.ub_skip_words(coords, rb, cb, row_ub),
              jpruning.ub_skip_words(coords, rb, cb, row_ub))
    # the unpacking the plain versions and the kernels read
    ti, tj = kernels.kept_tiles(_t(ub), nrb, ncb)
    keep = np.zeros((nrb, ncb), bool)
    keep[ti.numpy(), tj.numpy()] = True
    np.testing.assert_array_equal(keep, d2b <= row_ub[:, None])
    assert keep[::5].all() and not keep.all()


# -- populations ------------------------------------------------------------------

def _cross_rows(coords, rb, seed, n_blocks=4):
    """A row set of its own: ``n_blocks`` row blocks of jittered frames,
    then one row block of pads."""
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(len(coords), size=n_blocks * rb,
                              replace=False))
    rows = coords[pick] + rng.normal(0.0, 0.02, size=(len(pick),
                                                      coords.shape[1]))
    rows = np.concatenate([rows.astype(np.float32),
                           np.full((rb, coords.shape[1]), PAD, np.float32)])
    return rows


@pytest.mark.parametrize("d,rb,cb", [(2, 8, 16), (3, 16, 24), (4, 8, 16)])
def test_pops_tiles_match_pallas(d, rb, cb):
    n = 260
    c = _morton(_blobs(n, d, seed=d))
    padded = _pad(c, int(np.lcm(rb, cb)))
    ct = np.ascontiguousarray(padded.T)
    radii = np.asarray([0.1, 0.22, 0.35], np.float32)
    radii2 = radii * radii
    words, _ = tpruning.radius_skip_words(padded, rb, cb, radii2.max())
    assert (words != 0).any()  # pruning skips cells on this data
    want = np.asarray(pk.pops_tiles(ct, radii2, n, words, rb, cb))
    before = dict(kernels.LAUNCHES)
    got = kernels.pops_tiles(_t(ct), _t(radii2), n, _t(words), rb, cb)
    np.testing.assert_array_equal(got.numpy(), want)
    # the pruned count is the exact all-pairs count
    dense = tdops.populations_dense(c, list(radii))
    for k, r in enumerate(radii):
        np.testing.assert_array_equal(got.numpy()[k, :n], dense[r])
    assert not got.numpy()[:, n:].any()

    # the cross form: R_pad != N_pad, a pad-only row block, cells pruned
    # by the rows' own boxes against the columns'
    rows = _cross_rows(c, rb, seed=10 + d)
    rmin, rmax = tpruning.block_bboxes(rows, rb)
    cmin, cmax = tpruning.block_bboxes(padded, cb)
    skip = tpruning.bbox_dist2(rmin, rmax, cmin, cmax) > radii2.max()
    assert skip[:-1].any()
    cwords, _ = tpruning.pack_skip_words(skip)
    rows_t = np.ascontiguousarray(rows.T)
    want = np.asarray(pk.pops_tiles_cross(rows_t, ct, radii2, n, cwords,
                                          row_block=rb, col_block=cb))
    got = kernels.pops_tiles_cross(_t(rows_t), _t(ct), _t(radii2), n,
                                   _t(cwords), rb, cb)
    assert got.shape == (3, len(rows)) and len(rows) != len(padded)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy()[:, :-rb].any() and not got.numpy()[:, -rb:].any()
    # CPU tensors take the plain version: no kernel launch is counted
    assert kernels.LAUNCHES == before


def _tie_radii2(x, pairs, others):
    """Squared radii: the fma-chain d2 of each (i, j) pair of frames of
    ``x`` (N, D), so the pair sits exactly on its radius (d2 <= r^2 counts
    it), then ``others``; float32."""
    ties = [sq_dists(x[i:i + 1], x[j:j + 1])[0, 0] for i, j in pairs]
    return torch.cat([torch.stack(ties),
                      torch.as_tensor(np.asarray(others, np.float32),
                                      device=x.device)])


@pytest.mark.parametrize("d,rb,cb", [(1, 8, 16), (3, 16, 24), (4, 8, 16)])
def test_pops_tiles_nine_radii_and_ties_match_pallas(d, rb, cb):
    """Nine radii (two launch groups on the card), four of them ties -- the
    squared radius equals a pair's fma-chain d2 -- and one of 0 (the self
    pairs and the duplicates), on the cross form with skip words from the
    rows' boxes against the columns'."""
    n = 220
    c = _morton(_blobs(n, d, seed=50 + d, dup=3))
    padded = _pad(c, int(np.lcm(rb, cb)))
    ct = np.ascontiguousarray(padded.T)
    rows = _cross_rows(c, rb, seed=60 + d)
    rows[:4] = c[[0, 9, 90, 150]]  # rows that are columns: exact ties
    pairs = ((0, 5), (1, 30), (2, 91), (3, 160))  # (row, column)
    x = torch.from_numpy(np.concatenate([rows, padded]))
    radii2 = _tie_radii2(x, [(i, len(rows) + j) for i, j in pairs],
                         [0.0, 0.01, 0.05, 0.2, 0.5]).numpy()
    rmin, rmax = tpruning.block_bboxes(rows, rb)
    cmin, cmax = tpruning.block_bboxes(padded, cb)
    skip = tpruning.bbox_dist2(rmin, rmax, cmin, cmax) > radii2.max()
    assert skip.any() and not skip.all()
    words, _ = tpruning.pack_skip_words(skip)
    rows_t = np.ascontiguousarray(rows.T)
    want = np.asarray(pk.pops_tiles_cross(rows_t, ct, radii2, n, words,
                                          row_block=rb, col_block=cb))
    got = kernels.pops_tiles_cross(_t(rows_t), _t(ct), _t(radii2), n,
                                   _t(words), rb, cb).numpy()
    np.testing.assert_array_equal(got, want)
    # each tie radius counts its pair: one ulp less counts fewer
    below = np.nextafter(radii2[:4], np.float32(-np.inf))
    fewer = kernels.pops_tiles_cross(_t(rows_t), _t(ct), _t(below), n,
                                     _t(words), rb, cb).numpy()
    for k, (i, _) in enumerate(pairs):
        assert fewer[k, i] < want[k, i]


# -- nearest neighbours -----------------------------------------------------------

def _nn_layout(n, d, rb, cb, seed, dup=6):
    """Shuffled frames with duplicates and tied free energies, padded,
    with permuted original ids: (coords, padded, fe (1, N_pad),
    orig_ids (1, N_pad))."""
    rng = np.random.default_rng(seed)
    c = _blobs(n, d, seed, dup=dup)
    padded = _pad(c, int(np.lcm(rb, cb)))
    fe = np.full((1, len(padded)), np.inf, np.float32)
    fe[0, :n] = rng.integers(0, 4, size=n) / np.float32(4.0)  # ties
    oid = np.full((1, len(padded)), IMAX, np.int32)
    oid[0, :n] = rng.permutation(n)
    return c, padded, fe, oid


def _assert_nn_equal(got, want):
    """(nh_d, nh_j, hd_d, hd_j) equal at every position: ids exact,
    distances bit-equal."""
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if g.dtype == np.float32:
            np.testing.assert_array_equal(_bits(g), _bits(w))
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("d,rb,cb", [(2, 8, 16), (3, 16, 24), (4, 8, 16)])
def test_nn_tiles_match_pallas(d, rb, cb):
    n = 250
    c, padded, fe, oid = _nn_layout(n, d, rb, cb, seed=20 + d)
    ct = np.ascontiguousarray(padded.T)
    nrb, ncb = len(padded) // rb, len(padded) // cb
    skip = ~tpruning.band_mask(nrb, ncb, rb, cb, 2 * cb)
    skip[2] = True  # a row block wholly skipped
    words, _ = tpruning.pack_skip_words(skip)
    want = pk.nn_tiles(ct, fe, oid, n, words, rb, cb)
    before = dict(kernels.LAUNCHES)
    got = kernels.nn_tiles(_t(ct), _t(fe), _t(oid), n, _t(words), rb, cb)
    _assert_nn_equal(got, want)
    nh_d, nh_j, hd_d, hd_j = (a.numpy()[0] for a in got)
    blk = slice(2 * rb, 3 * rb)
    assert np.isinf(nh_d[blk]).all() and (nh_j[blk] == IMAX).all()
    assert np.isinf(hd_d[n:]).all() and (hd_j[n:] == IMAX).all()
    assert np.isfinite(nh_d[:n]).sum() > n // 2
    # a frame's duplicates are never its neighbours (d2 == 0)
    assert (nh_d[:n] > 0).all()

    # the cross form: a row set of its own and a pad-only row block
    rows = _cross_rows(c, rb, seed=30 + d)
    rows[:3] = c[0]  # rows equal to frame 0 and its duplicates
    rows_t = np.ascontiguousarray(rows.T)
    rng = np.random.default_rng(d)
    fe_rows = np.full((1, len(rows)), np.inf, np.float32)
    fe_rows[0, :-rb] = rng.integers(0, 4, size=len(rows) - rb) / 4.0
    nrb_r = len(rows) // rb
    cskip = rng.random((nrb_r, ncb)) < 0.4
    cskip[1] = True
    cwords, _ = tpruning.pack_skip_words(cskip)
    want = pk.nn_tiles_cross(rows_t, fe_rows, ct, fe, oid, n, cwords,
                             row_block=rb, col_block=cb)
    got = kernels.nn_tiles_cross(_t(rows_t), _t(fe_rows), _t(ct), _t(fe),
                                 _t(oid), n, _t(cwords), rb, cb)
    _assert_nn_equal(got, want)
    assert got[0].shape == (1, len(rows)) and len(rows) != len(padded)
    assert np.isfinite(got[2].numpy()).any()
    assert kernels.LAUNCHES == before


def _lattice_nn(n, d, rb, cb, seed):
    """Frames on a coarse lattice (coordinates multiples of 1/4, exact in
    float32: many d2 tie exactly and the smaller original id decides),
    frames 0..4 one point (d2 = 0 is never a neighbour), quantised fe (equal
    fe is not lower; the frames at the lowest fe have no lower-fe frame),
    permuted original ids: (coords, padded, fe (1, N_pad), oid (1, N_pad))."""
    rng = np.random.default_rng(seed)
    c = (rng.integers(-4, 5, size=(n, d)) / np.float32(4.0)).astype(
        np.float32)
    c[:5] = c[0]
    padded = _pad(c, int(np.lcm(rb, cb)))
    fe = np.full((1, len(padded)), np.inf, np.float32)
    fe[0, :n] = rng.integers(0, 3, size=n) / np.float32(2.0)
    oid = np.full((1, len(padded)), IMAX, np.int32)
    oid[0, :n] = rng.permutation(n)
    return c, padded, fe, oid


@pytest.mark.parametrize("d,rb,cb", [(1, 8, 16), (3, 16, 24), (4, 8, 16)])
def test_nn_tiles_lattice_ties_match_pallas(d, rb, cb):
    """nn_tiles on lattice frames (exact d2 ties broken by the smaller
    original id), duplicates, equal free energies and frames with no
    lower-fe frame, under random skip words with a wholly skipped row
    block: the plain version against the Pallas kernel, ids exact and
    distances bit-equal."""
    n = 230
    c, padded, fe, oid = _lattice_nn(n, d, rb, cb, seed=80 + d)
    ct = np.ascontiguousarray(padded.T)
    nrb, ncb = len(padded) // rb, len(padded) // cb
    rng = np.random.default_rng(d)
    skip = rng.random((nrb, ncb)) < 0.3
    skip[1] = True
    words, _ = tpruning.pack_skip_words(skip)
    want = pk.nn_tiles(ct, fe, oid, n, words, rb, cb)
    got = kernels.nn_tiles(_t(ct), _t(fe), _t(oid), n, _t(words), rb, cb)
    _assert_nn_equal(got, want)
    nh_d, nh_j, hd_d, hd_j = (a.numpy()[0] for a in got)
    # the kept cells hold exact ties at a row's minimum, won by the
    # smaller original id
    d2 = sq_dists(_t(c), _t(c)).numpy()
    keep = ~np.repeat(np.repeat(skip, rb, 0), cb, 1)[:n, :n]
    cand = keep & (d2 > 0) & (d2 == nh_d[:n, None])
    n_tied = cand.sum(axis=1)
    assert (n_tied > 1).sum() > n // 4
    tied = np.flatnonzero(n_tied > 1)
    ids = np.where(cand[tied], oid[0, :n][None, :], IMAX).min(axis=1)
    np.testing.assert_array_equal(nh_j[tied], ids)
    assert (nh_d[:n][np.isfinite(nh_d[:n])] > 0).all()
    lowest = np.flatnonzero(fe[0, :n] == 0.0)
    assert np.isinf(hd_d[lowest]).all() and (hd_j[lowest] == IMAX).all()
    assert np.isfinite(hd_d[:n]).sum() > n // 2


# -- the slice as a whole ---------------------------------------------------------

def _skip_word_slice(pkg, put, get, coords, radius, rb, cb):
    """Populations by ``pkg.pops_tiles`` under radius skip words, then NN
    by ``pkg.nn_tiles`` in two passes: a band pass, and a pass pruned by
    the band's per-row-block bounds, whose output alone is the answer.
    ``pkg`` is the JAX package's pallas_kernels or the port's kernels;
    frames in Morton order. Returns (pops, (nh_j, nh_d, hd_j, hd_d),
    kept cells of the second pass) in original frame order, absent
    neighbours as (0, 0.0)."""
    n = len(coords)
    order = tpruning.morton_order(coords)
    padded = _pad(coords[order], int(np.lcm(rb, cb)))
    nrb, ncb = len(padded) // rb, len(padded) // cb
    ct = np.ascontiguousarray(padded.T)
    r2 = np.float32(radius) * np.float32(radius)
    words, _ = tpruning.radius_skip_words(padded, rb, cb, r2, strict=True)
    counts = get(pkg.pops_tiles(put(ct), put(np.asarray([r2])), n,
                                put(words), rb, cb))
    pops = np.empty(n, np.int64)
    pops[order] = counts[0, :n]
    fe = jdops.free_energies(pops)
    fe_l = np.full((1, len(padded)), np.inf, np.float32)
    fe_l[0, :n] = fe[order]
    oid = np.full((1, len(padded)), IMAX, np.int32)
    oid[0, :n] = order
    band, _ = tpruning.band_skip_words(nrb, ncb, rb, cb,
                                       NN_BAND_BLOCKS * cb)
    nh_d, _, hd_d, _ = (get(a)[0] for a in pkg.nn_tiles(
        put(ct), put(fe_l), put(oid), n, put(band), rb, cb))
    ub = np.maximum(nh_d, hd_d)  # +inf where the band held no hd
    ub[n:] = 0.0                 # pads need no neighbour
    row_ub = ub.reshape(nrb, rb).max(axis=1)
    words2, _ = tpruning.ub_skip_words(padded, rb, cb, row_ub)
    kept = len(kernels.kept_tiles(_t(words2), nrb, ncb)[0])
    out = [get(a)[0, :n] for a in pkg.nn_tiles(
        put(ct), put(fe_l), put(oid), n, put(words2), rb, cb)]
    nn = []
    for d2, j in ((out[0], out[1]), (out[2], out[3])):
        absent = ~(d2 < np.inf)
        ids = np.empty(n, np.int64)
        ids[order] = np.where(absent, 0, j)
        dist = np.empty(n, np.float32)
        dist[order] = np.where(absent, 0.0, d2)
        nn += [ids, dist]
    return pops, tuple(nn), kept


@pytest.mark.parametrize("d,rb,cb", [(2, 8, 16), (3, 16, 24)])
def test_skip_word_slice_matches_jax(d, rb, cb):
    n, radius = 300, 0.2
    coords = _blobs(n, d, seed=40 + d, dup=4)
    pops, nn, kept = _skip_word_slice(
        kernels, _t, lambda t: t.numpy(), coords, radius, rb, cb)
    j_pops, j_nn, j_kept = _skip_word_slice(
        pk, lambda a: a, np.asarray, coords, radius, rb, cb)
    n_pad = -(-n // int(np.lcm(rb, cb))) * int(np.lcm(rb, cb))
    assert kept == j_kept and 0 < kept < (n_pad // rb) * (n_pad // cb)
    np.testing.assert_array_equal(pops, j_pops)
    for i in (0, 2):
        np.testing.assert_array_equal(nn[i], j_nn[i])
    for i in (1, 3):
        np.testing.assert_array_equal(_bits(nn[i]), _bits(j_nn[i]))
    eng = jengine.DensityEngine(coords, rb, cb, backend="pallas")
    np.testing.assert_array_equal(pops, eng.populations([radius])[radius])
    fe = jdops.free_energies(pops)
    want = eng.nearest_neighbors(fe)
    dense = tnops.nearest_neighbors_dense(coords, fe)
    for i in (0, 2):
        np.testing.assert_array_equal(nn[i], want[i])
        np.testing.assert_array_equal(nn[i], dense[i])
    for i in (1, 3):
        gap = np.abs(_bits(nn[i]).astype(np.int64)
                     - _bits(want[i]).astype(np.int64))
        assert gap.max() <= 1
        np.testing.assert_array_equal(_bits(nn[i]), _bits(dense[i]))
    lo = int(np.argmin(fe))  # no lower-fe neighbour: (0, 0.0)
    assert nn[2][lo] == 0 and nn[3][lo] == 0.0


# -- on the card ------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("d,rb,cb", [(2, 8, 16), (3, 16, 24), (4, 128, 4096),
                                     (17, 32, 64)])
def test_cuda_skip_word_kernels_match_plain(d, rb, cb):
    """pops_tiles_cross and nn_tiles_cross on a row set of its own, 11
    radii (two launches), a wholly skipped row block and skip words with
    bit 31 set, against their plain versions: exact."""
    _need_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(200 + d)
    n = 40 * cb + 37
    c = rng.normal(0.0, 0.3, size=(n, d)).astype(np.float32)
    c[:8] = c[0]
    padded = _pad(c, cb)
    rows = _cross_rows(c, rb, seed=d, n_blocks=6)
    nrb, ncb = len(rows) // rb, len(padded) // cb
    skip = rng.random((nrb, ncb)) < 0.4
    skip[:, 31] = True
    skip[2] = True
    words, _ = tpruning.pack_skip_words(skip)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    ct, rows_t, w = put(padded.T), put(rows.T), put(words)
    r2 = put(np.linspace(0.005, 0.3, 11).astype(np.float32))
    kernels.reset_launches()
    pargs = (rows_t, ct, r2, n, w, rb, cb)
    got = kernels.pops_tiles_cross(*pargs)
    assert torch.equal(got, kernels.pops_tiles_cross_plain(*pargs))
    assert got[:, 2 * rb:3 * rb].eq(0).all() and got.any()
    fe = np.full((1, len(padded)), np.inf, np.float32)
    fe[0, :n] = rng.integers(0, 5, size=n) / 4.0
    fe_r = np.full((1, len(rows)), np.inf, np.float32)
    fe_r[0, :-rb] = rng.integers(0, 5, size=len(rows) - rb) / 4.0
    oid = np.full((1, len(padded)), IMAX, np.int32)
    oid[0, :n] = rng.permutation(n)
    nargs = (rows_t, put(fe_r), ct, put(fe), put(oid), n, w, rb, cb)
    got = kernels.nn_tiles_cross(*nargs)
    want = kernels.nn_tiles_cross_plain(*nargs)
    for g, x in zip(got, want):
        assert torch.equal(g.view(torch.int32), x.view(torch.int32))
    assert torch.isfinite(got[2]).any()
    assert kernels.LAUNCHES["pops_tiles"] == 2
    assert kernels.LAUNCHES["nn_tiles"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 4, 8, 16, 17])
@pytest.mark.parametrize("rb,cb", [(128, 4096), (32, 256), (64, 64), (16, 24)])
def test_cuda_redesigned_pops_tiles_match_plain(d, rb, cb):
    """The micro-tiled pops_tiles_cross against its plain version with 1,
    2, 3, 8 and 9 radii (9: two launches; every radius-bucket instance),
    tie radii (squares equal to pairs' d2), a row set of its own
    (R_pad != N_pad) with duplicates of columns, n_valid inside a column
    block, a wholly skipped row block and skip bit 31: counts exact."""
    _need_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(300 + d + rb)
    n = 33 * cb + cb // 2 + 5
    c = rng.normal(0.0, 0.3, size=(n, d)).astype(np.float32)
    c[:8] = c[0]
    padded = _pad(c, cb)
    rows = _cross_rows(c, rb, seed=d, n_blocks=5)
    rows[:3] = c[[0, 1, n - 1]]
    nrb, ncb = len(rows) // rb, len(padded) // cb
    skip = rng.random((nrb, ncb)) < 0.4
    skip[:, 31] = True
    skip[2] = True
    skip[0, [0, ncb - 1]] = False
    words, _ = tpruning.pack_skip_words(skip)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    ct, rows_t, w = put(padded.T), put(rows.T), put(words)
    x = torch.cat([rows_t.T, ct.T])
    radii2 = _tie_radii2(x, [(0, len(rows) + 3), (1, len(rows) + n - 2),
                             (2, len(rows) + 40)],
                         [0.0, 0.002 * d, 0.01 * d, 0.04 * d, 0.1 * d,
                          0.4 * d])
    kernels.reset_launches()
    for k in (1, 2, 3, 8, 9):
        args = (rows_t, ct, radii2[:k].contiguous(), n, w, rb, cb)
        got = kernels.pops_tiles_cross(*args)
        assert torch.equal(got, kernels.pops_tiles_cross_plain(*args)), k
        assert got[:, 2 * rb:3 * rb].eq(0).all()
    assert bool((got[:, :rb] > 1).any())
    assert kernels.LAUNCHES["pops_tiles"] == 6


# squared radii at the edges of the kernel's one-fma count (as in
# tests/test_torch_kernels.py): below 2^-100 the exact compare takes over
EDGE_RADII2 = {
    "exact": [0.0, 1e-35, 2.0 ** -100, -1.0, float("nan"), float("inf"),
              float(np.finfo(np.float32).max)],
    "fma": [2.0 ** -100, 2.0 ** -99.5, -1.0, float("nan"), float("inf"),
            float(np.finfo(np.float32).max), 1e30],
}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 17])
@pytest.mark.parametrize("which", sorted(EDGE_RADII2))
def test_cuda_pops_tiles_edge_radii_match_plain(d, which):
    """pops_tiles_cross with radii at the edges of its one-fma count, and
    a tie radius, on a row set with a pad-only row block (d2 = inf: inf
    counts it, FLT_MAX does not), against its plain version: exact."""
    _need_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(400 + d)
    n = 5 * 64 + 9
    c = rng.normal(0.0, 0.3, size=(n, d)).astype(np.float32)
    c[:4] = c[0]
    padded = _pad(c, 64)
    rows = _cross_rows(c, 32, seed=d)
    rows[0] = c[7]
    skip = rng.random((len(rows) // 32, len(padded) // 64)) < 0.3
    words, _ = tpruning.pack_skip_words(skip)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    rows_t, ct = put(rows.T), put(padded.T)
    x = torch.cat([rows_t.T, ct.T])
    radii2 = _tie_radii2(x, [(0, len(rows) + 9)], EDGE_RADII2[which])
    args = (rows_t, ct, radii2, n, put(words), 32, 64)
    got = kernels.pops_tiles_cross(*args)
    assert torch.equal(got, kernels.pops_tiles_cross_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 4, 8, 16, 17])
@pytest.mark.parametrize("rb,cb", [(128, 4096), (32, 256), (64, 64), (16, 24)])
def test_cuda_redesigned_nn_tiles_match_plain(d, rb, cb):
    """The micro-tiled nn_tiles against its plain version on lattice frames
    (exact d2 ties: the smaller original id decides), duplicated frames
    (d2 = 0 is never a candidate), equal free energies (not lower) and
    rows with no lower-fe frame: the cross form on a row set of its own
    (copies of columns, a pad-only row block) under random skip words with
    bit 31 set and a wholly skipped row block, then the square form under
    band words over the padded frames; ids exact, distances bit-equal."""
    _need_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(700 + d + rb)
    n = 33 * cb + cb // 2 + 5
    c, padded, fe, oid = _lattice_nn(n, d, rb, cb, seed=d + rb)
    rows = np.full((6 * rb, d), PAD, np.float32)
    pick = rng.integers(0, n, size=5 * rb)
    pick[:3] = [0, 1, n - 1]
    rows[:5 * rb] = c[pick]
    fe_r = np.full((1, len(rows)), np.inf, np.float32)
    fe_r[0, :5 * rb] = fe[0, pick]
    fe_r[0, 7] = -1.0  # below every column: no lower-fe frame
    nrb, ncb = len(rows) // rb, len(padded) // cb
    assert ncb > 32
    skip = rng.random((nrb, ncb)) < 0.4
    skip[:, 31] = True
    skip[2] = True
    skip[0, [0, ncb - 1]] = False
    words, _ = tpruning.pack_skip_words(skip)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    ct, fe_d, oid_d = put(padded.T), put(fe), put(oid)
    kernels.reset_launches()
    args = (put(rows.T), put(fe_r), ct, fe_d, oid_d, n, put(words), rb, cb)
    got = kernels.nn_tiles_cross(*args)
    want = kernels.nn_tiles_cross_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    nh_d, nh_j, hd_d, _ = (a[0] for a in got)
    assert torch.isinf(nh_d[2 * rb:3 * rb]).all()
    assert bool((nh_j[2 * rb:3 * rb] == IMAX).all())
    assert torch.isinf(hd_d[7]) and torch.isfinite(hd_d).any()
    assert bool((nh_d[torch.isfinite(nh_d)] > 0).all())

    words = put(tpruning.band_skip_words(len(padded) // rb, ncb, rb, cb,
                                         2 * cb)[0])
    args = (ct, fe_d, ct, fe_d, oid_d, n, words, rb, cb)
    got = kernels.nn_tiles(ct, fe_d, oid_d, n, words, rb, cb)
    for g, w in zip(got, kernels.nn_tiles_cross_plain(*args)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert torch.isfinite(got[0][0, :n]).all()
    assert kernels.LAUNCHES["nn_tiles"] == 2
