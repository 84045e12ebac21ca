"""The port's symmetric (row-side) tile-sweep path against the JAX package.

Kernels: the plain versions of ``pops_sparse``, ``nn_sparse`` and
``label_min_sparse`` (what every wrapper takes for CPU tensors) against
``pops_tiles_sparse_cross``, ``nn_tiles_sparse_cross`` and
``label_min_sparse_cross`` in interpret mode, on cross-form inputs: a row
set apart from the column set. Exact: counts, ids and labels equal,
distances bit-equal (both sides compute the plain fma chain).

Engines: with the bidirectional switches off (``POPS_BIDIR``, ``NN_BIDIR``,
``BIDIR``), the port's engines against the JAX engines with theirs off
(``POPS_BIDIR_SCRATCH_CAP``, ``NN_BIDIR_SCRATCH_CAP``, ``BIDIR_UNION_VMEM``
= 0, as tests/test_pallas_interpret.py sets them), and against the port's
own bidirectional path. Populations, ids and clusterings exact; NN
distances bit-equal within the port, and within 1 ulp of the JAX engine,
which recomputes them with XLA's arithmetic (ROADMAP.md, "Distance
arithmetic").
"""

import numpy as np
import pytest
import torch

from clustering_tpu import ops as jops
from clustering_tpu.ops import engine as jengine
from clustering_tpu.ops import neighbors as jnops
from clustering_tpu.ops import pallas_kernels as pk
from clustering_tpu.ops import screening as jscreening
from clustering_tpu_torch.ops import density as tdops
from clustering_tpu_torch.ops import engine as tengine
from clustering_tpu_torch.ops import kernels
from clustering_tpu_torch.ops import neighbors as tnops
from clustering_tpu_torch.ops import screening as tscreening

RB, CB = 8, 16
IMAX = np.iinfo(np.int32).max


def _padded_t(c, block):
    n_pad = -(-len(c) // block) * block
    ct = np.full((c.shape[1], n_pad), np.float32(3e38), dtype=np.float32)
    ct[:, :len(c)] = c.T
    return ct


def _cross(d, seed, n_cols=200, n_rows=52):
    """(rows_t, cols_t, n_cols): two blobs of columns and a row set of its
    own, a few rows exact copies of columns (d2 == 0 pairs)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0.0, 0.3, size=(n_cols, d)).astype(np.float32)
    c[n_cols // 2:] += np.float32(1.0)
    r = rng.normal(0.5, 0.5, size=(n_rows, d)).astype(np.float32)
    r[:6] = c[rng.integers(0, n_cols, size=6)]
    return _padded_t(r, RB), _padded_t(c, CB), n_cols


def _sorted_tiles(nrb, ncb, seed, frac):
    rng = np.random.default_rng(seed)
    ti, tj = np.nonzero(rng.random((nrb, ncb)) < frac)
    return ti.astype(np.int32), tj.astype(np.int32)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_pops_sparse_matches_pallas(d):
    rows_t, cols_t, n = _cross(d, seed=d)
    radii2 = np.asarray([0.05, 0.2, 0.6], dtype=np.float32)
    ti, tj = _sorted_tiles(rows_t.shape[1] // RB, cols_t.shape[1] // CB,
                           seed=10 + d, frac=0.7)
    rng = np.random.default_rng(d)
    rmask = rng.integers(0, 8, size=len(ti)).astype(np.int32)
    # one no-op pad entry, as the JAX planner emits them
    ti = np.append(ti, ti[-1]).astype(np.int32)
    tj = np.append(tj, -1).astype(np.int32)
    rmask = np.append(rmask, 0).astype(np.int32)
    want = pk.pops_tiles_sparse_cross(rows_t, cols_t, radii2, np.int32(n),
                                      ti, tj, rmask=rmask, row_block=RB,
                                      col_block=CB)
    before = dict(kernels.LAUNCHES)
    got = kernels.pops_sparse(
        torch.from_numpy(rows_t), torch.from_numpy(cols_t),
        torch.from_numpy(radii2), n, torch.from_numpy(ti),
        torch.from_numpy(tj), torch.from_numpy(rmask), RB, CB)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.numpy().sum() > 0
    # CPU tensors take the plain version: no kernel launch is counted
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("d,rb,cb", [(1, 8, 16), (3, 16, 24), (4, 8, 16)])
def test_pops_sparse_nine_radii_ties_and_partial_rmask_match_pallas(d, rb,
                                                                   cb):
    """Nine radii (two launch groups on the card), four of them ties -- the
    squared radius equals a row's fma-chain d2 to a column -- and one of 0,
    under a random partial rmask per tile (the tie bits set on the tie
    rows' tiles), with tj = -1 and rmask = 0 entries and n_valid inside a
    column block: the plain version against the Pallas kernel, exact."""
    rng = np.random.default_rng(90 + d)
    n = 230
    c = rng.normal(0.0, 0.3, size=(n, d)).astype(np.float32)
    c[n // 2:] += np.float32(1.0)
    c[:4] = c[0]
    rows = np.concatenate([c[[0, 9, 120, 200]],
                           rng.normal(0.5, 0.5, size=(3 * rb - 4, d))])
    rows_t = _padded_t(rows.astype(np.float32), rb)
    cols_t = _padded_t(c, cb)
    assert n % cb and rows_t.shape[1] != cols_t.shape[1]
    pairs = ((0, 5), (1, 30), (2, 121), (3, 229))  # (row, column)
    x = torch.from_numpy(np.concatenate([rows_t.T, cols_t.T]))
    ties = [float(tdops.sq_dists(x[i:i + 1], x[len(rows_t.T) + j:
                                               len(rows_t.T) + j + 1])[0, 0])
            for i, j in pairs]
    radii2 = np.asarray(ties + [0.0, 0.01, 0.05, 0.2, 0.5], np.float32)
    act = rng.random((rows_t.shape[1] // rb, cols_t.shape[1] // cb)) < 0.8
    act[0] = True  # the tie rows' tiles
    ti, tj = (a.astype(np.int32) for a in np.nonzero(act))
    rmask = rng.integers(0, 1 << 9, size=len(ti)).astype(np.int32)
    rmask[rng.random(len(ti)) < 0.1] = 0
    rmask[ti == 0] |= 0b11111
    # no-op pad entries, as the JAX planner emits them
    ti = np.append(ti, [ti[-1], ti[-1]]).astype(np.int32)
    tj = np.append(tj, [-1, -1]).astype(np.int32)
    rmask = np.append(rmask, [0, 0]).astype(np.int32)
    assert (rmask == 0).sum() > 1 and ((rmask != 0) & (rmask != 511)).any()
    want = np.asarray(pk.pops_tiles_sparse_cross(
        rows_t, cols_t, radii2, np.int32(n), ti, tj, rmask=rmask,
        row_block=rb, col_block=cb))

    def run(r2):
        return kernels.pops_sparse(
            torch.from_numpy(rows_t), torch.from_numpy(cols_t),
            torch.from_numpy(r2), n, torch.from_numpy(ti),
            torch.from_numpy(tj), torch.from_numpy(rmask), rb, cb).numpy()

    got = run(radii2)
    np.testing.assert_array_equal(want, got)
    assert (got[4, :4] >= 1).all()  # r = 0: the rows that are columns
    # each tie radius counts its pair: one ulp less counts fewer
    fewer = run(np.nextafter(radii2[:4], np.float32(-np.inf)))
    for k, (i, _) in enumerate(pairs):
        assert fewer[k, i] < got[k, i]


@pytest.mark.parametrize("d", [2, 3, 4])
def test_nn_sparse_matches_pallas(d):
    rows_t, cols_t, n = _cross(d, seed=20 + d)
    r_pad, n_pad = rows_t.shape[1], cols_t.shape[1]
    n_rows = 52
    rng = np.random.default_rng(30 + d)
    # quantised free energies: plenty of ties, which never qualify for hd
    fe_cols = np.full(n_pad, np.inf, np.float32)
    fe_cols[:n] = rng.integers(0, 6, size=n) / np.float32(4.0)
    fe_rows = np.full(r_pad, np.inf, np.float32)
    fe_rows[:n_rows] = rng.integers(0, 6, size=n_rows) / np.float32(4.0)
    fe_rows[7] = -1.0  # below every column: no lower-fe neighbour
    oid = np.full(n_pad, IMAX, np.int32)
    oid[:n] = rng.permutation(n)
    oid_rows = np.full(r_pad, IMAX, np.int32)
    oid_rows[:n_rows] = rng.permutation(n)[:n_rows]
    ti, tj = _sorted_tiles(r_pad // RB, n_pad // CB, seed=40 + d, frac=0.6)
    # repeat the last tile, as the JAX planner pads (the min is idempotent)
    ti, tj = np.append(ti, ti[-1]), np.append(tj, tj[-1])
    want_d, want_j = pk.nn_tiles_sparse_cross(
        rows_t, fe_rows.reshape(1, -1), cols_t, fe_cols.reshape(1, -1),
        oid.reshape(1, -1), np.int32(n), ti, tj, row_block=RB, col_block=CB)
    want_d, want_j = np.asarray(want_d), np.asarray(want_j)
    keys = kernels.nn_keys_init(n_pad, "cpu")
    kernels.nn_sparse(torch.from_numpy(rows_t), torch.from_numpy(fe_rows),
                      torch.from_numpy(oid_rows), torch.from_numpy(cols_t),
                      torch.from_numpy(fe_cols), torch.from_numpy(oid), n,
                      torch.from_numpy(ti), torch.from_numpy(tj), keys, RB,
                      CB)
    got_d, got_j = kernels.unpack_keys(keys)
    # keys are indexed by original id; the Pallas output by row position
    slots = oid_rows[:n_rows]
    np.testing.assert_array_equal(want_j[:, :n_rows], got_j.numpy()[:, slots])
    np.testing.assert_array_equal(want_d[:, :n_rows], got_d.numpy()[:, slots])
    # pad rows found nothing and wrote nothing
    assert (want_j[:, n_rows:] == IMAX).all()
    untouched = np.setdiff1d(np.arange(n_pad), slots)
    assert (keys.numpy()[:, untouched] == kernels.KEY_NONE).all()
    assert want_j[1, 7] == IMAX and (want_j[0, :n_rows] != IMAX).any()


@pytest.mark.parametrize("d", [2, 3, 4])
def test_label_min_sparse_matches_pallas(d):
    rng = np.random.default_rng(50 + d)
    n = 230
    c = rng.normal(0.0, 0.3, size=(n, d)).astype(np.float32)
    c[40:48] = c[3]  # duplicate frames
    cols_t = _padded_t(c, CB)
    n_pad = cols_t.shape[1]
    # the rows are the frames of a shard: 10 row blocks from block 3 on
    off, n_rb = 3, 10
    rows_t = np.ascontiguousarray(cols_t[:, off * RB:(off + n_rb) * RB])
    labels = np.arange(n_pad, dtype=np.int32)
    labels[:n] = np.minimum(labels[:n], rng.integers(0, n, size=n))
    ncb = n_pad // CB
    dirty = (rng.random(ncb) < 0.6).astype(np.int32)
    dirty[0] = 0
    ti, tj = _sorted_tiles(n_rb, ncb, seed=60 + d, frac=0.8)
    ti, tj = np.append(ti, ti[-1]), np.append(tj, tj[-1])
    n_below, md2 = 90, np.float32(0.2)
    want = pk.label_min_sparse_cross(
        rows_t, cols_t, labels.reshape(1, -1), np.int32(n_below), md2, ti,
        tj, np.int32(off), dirty=dirty, row_block=RB, col_block=CB)
    got = kernels.label_min_sparse(
        torch.from_numpy(rows_t), torch.from_numpy(cols_t),
        torch.from_numpy(labels), n_below, md2, torch.from_numpy(ti),
        torch.from_numpy(tj), off, torch.from_numpy(dirty), RB, CB)
    np.testing.assert_array_equal(np.asarray(want)[0], got.numpy())
    got = got.numpy()
    # rows past n_below (global 90 = local 66) propose nothing
    assert (got[n_below - off * RB:] == IMAX).all()
    assert (got[:n_below - off * RB] < IMAX).any()


def _permuted(ti, tj, order, n_row_blocks, n_col_blocks, offset=0):
    """The list (ti, tj) in wave order or in a random order (numpy)."""
    if order == "waves":
        perm = kernels.wave_order(torch.from_numpy(ti), torch.from_numpy(tj),
                                  RB, CB, n_row_blocks, n_col_blocks,
                                  offset).numpy()
    else:
        perm = np.random.default_rng(len(ti)).permutation(len(ti))
    assert not np.array_equal(perm, np.arange(len(ti)))
    return ti[perm], tj[perm]


def _nn_cross_inputs(d, seed):
    """Cross-form NN inputs: rows of their own with quantised fe (one row
    below every column), pad rows with id INT32_MAX, columns with ids."""
    rows_t, cols_t, n = _cross(d, seed=seed)
    r_pad, n_pad = rows_t.shape[1], cols_t.shape[1]
    n_rows = 52
    rng = np.random.default_rng(seed + 1)
    fe_cols = np.full(n_pad, np.inf, np.float32)
    fe_cols[:n] = rng.integers(0, 6, size=n) / np.float32(4.0)
    fe_rows = np.full(r_pad, np.inf, np.float32)
    fe_rows[:n_rows] = rng.integers(0, 6, size=n_rows) / np.float32(4.0)
    fe_rows[7] = -1.0  # below every column: no lower-fe neighbour
    oid = np.full(n_pad, IMAX, np.int32)
    oid[:n] = rng.permutation(n)
    oid_rows = np.full(r_pad, IMAX, np.int32)
    oid_rows[:n_rows] = rng.permutation(n)[:n_rows]
    return rows_t, fe_rows, oid_rows, cols_t, fe_cols, oid, n


def _nn_port(inputs, ti, tj, keys=None):
    rows_t, fe_rows, oid_rows, cols_t, fe_cols, oid, n = inputs
    if keys is None:
        keys = kernels.nn_keys_init(cols_t.shape[1], "cpu")
    return kernels.nn_sparse(*map(torch.from_numpy, (rows_t, fe_rows,
                                                     oid_rows, cols_t,
                                                     fe_cols, oid)),
                             n, torch.from_numpy(ti), torch.from_numpy(tj),
                             keys, RB, CB)


def _nn_pallas_keys(inputs, ti, tj):
    """nn_tiles_sparse_cross on (ti, tj) as (2, R_pad) packed keys in row
    position: (float_bits(d2) << 32) | id, (inf, IMAX) for none."""
    rows_t, fe_rows, _, cols_t, fe_cols, oid, n = inputs
    d2, j = pk.nn_tiles_sparse_cross(
        rows_t, fe_rows.reshape(1, -1), cols_t, fe_cols.reshape(1, -1),
        oid.reshape(1, -1), np.int32(n), ti, tj, row_block=RB, col_block=CB)
    d2 = np.asarray(d2, np.float32).view(np.uint32).astype(np.int64)
    return (d2 << 32) | np.asarray(j).astype(np.int64)


@pytest.mark.parametrize("order", ["waves", "random"])
@pytest.mark.parametrize("d", [1, 4])
def test_sparse_kernels_on_permuted_lists_match_pallas(d, order):
    """nn_sparse and label_min_sparse on their tile list permuted (the
    wave order the CUDA branch runs, or a random one) equal the Pallas
    kernels on the row-major list: the results cannot depend on the order."""
    inputs = _nn_cross_inputs(d, seed=70 + d)
    rows_t, _, oid_rows, cols_t, *_ = inputs
    nrb, ncb = rows_t.shape[1] // RB, cols_t.shape[1] // CB
    ti, tj = _sorted_tiles(nrb, ncb, seed=80 + d, frac=0.6)
    want = _nn_pallas_keys(inputs, ti, tj)
    # the port's list also holds a repeat and a tj = -1 no-op
    pti, ptj = _permuted(np.append(ti, [ti[-1], 2]).astype(np.int32),
                         np.append(tj, [tj[-1], -1]).astype(np.int32),
                         order, nrb, ncb)
    got = _nn_port(inputs, pti, ptj).numpy()
    slots = oid_rows[oid_rows != IMAX]
    np.testing.assert_array_equal(got[:, slots], want[:, oid_rows != IMAX])

    c = np.random.default_rng(d).normal(0.0, 0.3, size=(230, d))
    cols_t = _padded_t(c.astype(np.float32), CB)
    off, n_rb = 2, 11
    rows_t = np.ascontiguousarray(cols_t[:, off * RB:(off + n_rb) * RB])
    labels = np.arange(cols_t.shape[1], dtype=np.int32)
    labels[:230] = np.minimum(labels[:230],
                              np.random.default_rng(d).integers(0, 230, 230))
    ncb = cols_t.shape[1] // CB
    dirty = (np.arange(ncb) % 3 != 1).astype(np.int32)
    ti, tj = _sorted_tiles(n_rb, ncb, seed=90 + d, frac=0.8)
    n_below, md2 = 101, np.float32(0.15)
    want = pk.label_min_sparse_cross(
        rows_t, cols_t, labels.reshape(1, -1), np.int32(n_below), md2, ti,
        tj, np.int32(off), dirty=dirty, row_block=RB, col_block=CB)
    pti, ptj = _permuted(ti, tj, order, n_rb, ncb, off)
    got = kernels.label_min_sparse(
        torch.from_numpy(rows_t), torch.from_numpy(cols_t),
        torch.from_numpy(labels), n_below, md2, torch.from_numpy(pti),
        torch.from_numpy(ptj), off, torch.from_numpy(dirty), RB, CB)
    np.testing.assert_array_equal(np.asarray(want)[0], got.numpy())
    assert (got.numpy() < IMAX).any()


@pytest.mark.parametrize("d", [2, 3])
def test_nn_sparse_into_seeded_buffer_matches_two_pallas_passes(d):
    """A second nn_sparse call into a buffer that holds the first call's
    keys (the engine's band pass, then phase 2) ends at the lexicographic
    minimum of the two nn_tiles_sparse_cross outputs: starting from held
    keys loses none."""
    inputs = _nn_cross_inputs(d, seed=100 + d)
    rows_t, _, oid_rows, cols_t, *_ = inputs
    nrb, ncb = rows_t.shape[1] // RB, cols_t.shape[1] // CB
    ti1, tj1 = _sorted_tiles(nrb, ncb, seed=110 + d, frac=0.3)
    ti2, tj2 = _sorted_tiles(nrb, ncb, seed=120 + d, frac=0.5)
    keys = _nn_port(inputs, ti1, tj1)
    first = keys.clone()
    _nn_port(inputs, *_permuted(ti2, tj2, "waves", nrb, ncb), keys=keys)
    want = np.minimum(_nn_pallas_keys(inputs, ti1, tj1),
                      _nn_pallas_keys(inputs, ti2, tj2))
    real = oid_rows != IMAX
    np.testing.assert_array_equal(keys.numpy()[:, oid_rows[real]],
                                  want[:, real])
    # the second pass lowered some keys and found some rows new ones
    assert (keys != first).any()


@pytest.mark.parametrize("rb,cb,offset", [(8, 16, 0), (16, 24, 3),
                                          (128, 64, 1)])
def test_wave_order_is_a_permutation_diagonal_first(rb, cb, offset):
    """kernels.wave_order: a permutation of the list; per row block the
    diagonal column block first, then jd + 1, jd - 1, jd + 2, ...; waves
    in row block order; tj = -1 entries last."""
    nrb, ncb = 9, 12
    rng = np.random.default_rng(rb + offset)
    ti, tj = np.nonzero(rng.random((nrb, ncb)) < 0.7)
    ti = np.append(ti, [0, 4, 4]).astype(np.int32)
    tj = np.append(tj, [-1, 3, -1]).astype(np.int32)  # a repeat, pads
    shuffle = rng.permutation(len(ti))
    ti, tj = ti[shuffle], tj[shuffle]
    perm = kernels.wave_order(torch.from_numpy(ti), torch.from_numpy(tj),
                              rb, cb, nrb, ncb, offset).numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(len(ti)))
    oti, otj = ti[perm], tj[perm]
    jd = np.minimum((oti + offset) * rb // cb, ncb - 1)
    delta = otj - jd
    rank = np.where(otj < 0, 2 * ncb + 1,
                    np.where(delta > 0, 2 * delta - 1, -2 * delta))
    key = rank * nrb + oti
    assert (np.diff(key) >= 0).all()
    n_diag = int((delta == 0).sum())
    assert n_diag > 0 and (delta[:n_diag] == 0).all()
    assert (otj[-2:] == -1).all() and (otj[:-2] >= 0).all()
    for i in range(nrb):
        seq = otj[(oti == i) & (otj >= 0)]
        seq = seq[np.r_[True, np.diff(seq) != 0]]  # drop the repeat
        jd_i = min((i + offset) * rb // cb, ncb - 1)
        dist = np.abs(seq - jd_i)
        assert (np.diff(dist) >= 0).all()
        # at equal distance the block after the diagonal comes first
        for a, b in zip(seq[:-1], seq[1:]):
            if abs(a - jd_i) == abs(b - jd_i):
                assert a > b


# -- engines -------------------------------------------------------------------

def _blobs(n, d, seed, dup=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(0.0, 0.15, size=(n // 2, d))
    b = rng.normal(1.2, 0.2, size=(n - n // 2, d))
    c = np.concatenate([a, b])[rng.permutation(n)].astype(np.float32)
    if dup:
        c[-dup:] = c[0]  # exact duplicates: d2 == 0 is never a neighbour
    return c


def _assert_ulp_close(a, b, ulps=1):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    gap = np.abs(a.view(np.int32).astype(np.int64)
                 - b.view(np.int32).astype(np.int64))
    assert gap.max() <= ulps, gap.max()


def _fe(coords, rb=RB, cb=CB):
    pops = jops.populations(coords, [0.3], backend="xla", row_block=rb,
                            col_block=cb)[0.3]
    return jops.free_energies(pops)


def _symmetric_density(coords, rb=RB, cb=CB):
    eng = tengine.DensityEngine(coords, rb, cb, device="cpu")
    eng.POPS_BIDIR = False
    eng.NN_BIDIR = False
    return eng


def _symmetric_jax(coords, rb=RB, cb=CB):
    eng = jengine.DensityEngine(coords, rb, cb, backend="pallas")
    eng.POPS_BIDIR_SCRATCH_CAP = 0
    eng.NN_BIDIR_SCRATCH_CAP = 0
    return eng


def test_blocks_that_do_not_divide_match_jax():
    """(row_block, col_block) = (16, 24): N pads to lcm 48, populations
    sweep bidirectionally, NN and screening symmetrically (24 % 16 != 0),
    and every result equals the JAX package's at the same blocks."""
    rb, cb = 16, 24
    coords = _blobs(300, 3, seed=3)
    radii = [0.15, 0.3]
    je = jengine.DensityEngine(coords, rb, cb, backend="pallas")
    te = tengine.DensityEngine(coords, rb, cb, device="cpu")
    assert te.n_pad == je.n_pad == 336
    want = je.populations(radii)
    got = te.populations(radii)
    assert te.last_stats["populations"]["mode"] == "bidir"
    for r in radii:
        np.testing.assert_array_equal(got[r], want[r])
    fe = jops.free_energies(want[0.3])
    want = je.nearest_neighbors(fe)
    got = te.nearest_neighbors(fe)
    stats = te.last_stats["nn"]
    assert stats["route"] == "symmetric" and stats["band_tiles"] > 0
    assert not je.last_stats["nn"]["bidir"]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    _assert_ulp_close(got[1], want[1])
    _assert_ulp_close(got[3], want[3])
    cs = coords[np.argsort(fe, kind="stable")]
    labels0 = np.arange(len(cs), dtype=np.int32)
    for nb, md2 in ((150, 0.01), (300, 0.05)):
        want = jscreening.screening_labels(cs, labels0, nb, md2, rb, cb,
                                           backend="pallas")
        ts = tscreening.ScreeningEngine(cs, rb, cb, device="cpu")
        got = ts.run(labels0, nb, md2)
        assert ts.n_pad == 336 and ts.last_stats["mode"] == "symmetric"
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got[:nb])) < nb  # something was merged


@pytest.mark.parametrize("d", [2, 3, 4])
def test_symmetric_populations_match_jax_and_bidir(d):
    coords = _blobs(300, d, seed=d)
    coords[40:52] = coords[7]  # duplicate frames
    radii = [0.1, 0.15, 0.3]
    je = _symmetric_jax(coords)
    want = je.populations(radii)
    te = _symmetric_density(coords)
    got = te.populations(radii)
    assert te.last_stats["populations"]["mode"] == "symmetric"
    assert je.last_stats["populations"]["mode"] == "symmetric"
    assert (te.last_stats["populations"]["computed_tiles"]
            == je.last_stats["populations"]["computed_tiles"])
    bidir = tengine.DensityEngine(coords, RB, CB, device="cpu")
    got_b = bidir.populations(radii)
    assert bidir.last_stats["populations"]["mode"] == "bidir"
    # each unordered pair once: fewer tiles than the symmetric plan
    assert (bidir.last_stats["populations"]["computed_tiles"]
            < te.last_stats["populations"]["computed_tiles"])
    for r in radii:
        np.testing.assert_array_equal(got[r], want[r])
        np.testing.assert_array_equal(got_b[r], got[r])


@pytest.mark.parametrize("d,dup", [(2, 0), (3, 6), (4, 0)])
def test_symmetric_nn_match_jax_and_bidir(d, dup):
    coords = _blobs(360, d, seed=10 + d, dup=dup)
    fe = _fe(coords)
    je = _symmetric_jax(coords)
    want = je.nearest_neighbors(fe, band_blocks=tengine.NN_BAND_BLOCKS,
                                tier_qs=None)
    te = _symmetric_density(coords)
    got = te.nearest_neighbors(fe)
    ts, js = te.last_stats["nn"], je.last_stats["nn"]
    assert ts["route"] == "symmetric" and not js["bidir"]
    assert ts["band_tiles"] > 0
    for key in ("order", "band_tiles", "phase2_tiles"):
        assert ts[key] == js[key], key
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    _assert_ulp_close(got[1], want[1])
    _assert_ulp_close(got[3], want[3])
    bidir = tengine.DensityEngine(coords, RB, CB, device="cpu")
    got_b = bidir.nearest_neighbors(fe)
    assert bidir.last_stats["nn"]["route"] == "bidir"
    for a, b in zip(got, got_b):
        np.testing.assert_array_equal(a, b)  # distances bit-equal too


@pytest.mark.parametrize("seeded", [False, True])
def test_symmetric_series_matches_jax_and_bidir(seeded):
    coords = _blobs(500, 3, seed=21)
    fe = _fe(coords)
    nn = jops.nearest_neighbors(coords, fe, backend="xla", row_block=RB,
                                col_block=CB)
    thresholds = [np.float32(t) for t in
                  np.quantile(fe, [0.1, 0.35, 0.7, 1.0])]
    md2 = np.float32(4.0 * jnops.compute_sigma2(nn[1]))
    hd = (nn[2], nn[3]) if seeded else None
    js = jscreening.ThresholdSeriesScreener(coords, fe, thresholds, RB, CB,
                                            backend="pallas",
                                            hd_neighbors=hd)
    js.engine.BIDIR_UNION_VMEM = 0
    ts = tscreening.ThresholdSeriesScreener(coords, fe, thresholds, RB, CB,
                                            device="cpu", hd_neighbors=hd)
    ts.engine.BIDIR = False
    tb = tscreening.ThresholdSeriesScreener(coords, fe, thresholds, RB, CB,
                                            device="cpu", hd_neighbors=hd)
    a = b = c = None
    for k in range(len(thresholds)):
        a = js.step(a, k, md2)
        b = ts.step(b, k, md2)
        c = tb.step(c, k, md2)
        assert js.engine.last_stats["mode"] == "symmetric"
        assert ts.engine.last_stats["mode"] == "symmetric"
        assert tb.engine.last_stats["mode"] == "bidir"
        # the symmetric list holds both orientations of the triangle's
        assert (ts.engine.last_stats["tiles_per_sweep"]
                > tb.engine.last_stats["tiles_per_sweep"])
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, b)
    assert a.max() > 1


def test_ops_entry_points_match_jax():
    coords = _blobs(300, 2, seed=51)
    radii = [0.2, 0.3]
    want = jops.populations(coords, radii, backend="pallas", row_block=RB,
                            col_block=CB)
    got = tdops.populations(coords, radii, RB, CB, device="cpu")
    for r in radii:
        np.testing.assert_array_equal(got[r], want[r])
    fe = jops.free_energies(want[0.3])
    want = jops.nearest_neighbors(coords, fe, backend="pallas", row_block=RB,
                                  col_block=CB)
    got = tnops.nearest_neighbors(coords, fe, RB, CB, device="cpu")
    for i in (0, 2):
        np.testing.assert_array_equal(got[i], want[i])
    for i in (1, 3):
        _assert_ulp_close(got[i], want[i])
    cs = coords[np.argsort(fe, kind="stable")]
    labels0 = np.arange(len(cs), dtype=np.int32)
    labels0[5] = 2  # a seed equivalence
    want = jscreening.screening_labels(cs, labels0, 240, 0.02, RB, CB,
                                       backend="pallas")
    got = tscreening.screening_labels(cs, labels0, 240, 0.02, RB, CB,
                                      device="cpu")
    np.testing.assert_array_equal(got, want)
