"""The port's bidirectional tile-sweep kernels against the JAX package's
Pallas kernels (run in interpret mode, as tests/test_pallas_interpret.py
runs them) on identical inputs and tile lists; the row-side kernels are
pinned the same way in tests/test_torch_symmetric.py.

On the CPU every wrapper takes its plain PyTorch version, so these tests
pin the plain versions -- the oracles the CUDA kernels are held to -- to
the reference kernels. The tests marked ``cuda`` hold the six tile-list
CUDA kernels to their plain versions on the card and skip without one
(the two skip-word kernels: tests/test_torch_skip_words.py).

Counts, ids and labels must be exact. Distances must be bit-equal: both
sides compute the plain fma chain acc = fma(d_k, d_k, acc) from zero.
"""

import numpy as np
import pytest
import torch

from clustering_tpu.ops import pallas_kernels as pk
from clustering_tpu_torch.ops import kernels, pruning
from clustering_tpu_torch.ops.pairwise import sq_dists

RB, CB = 8, 16
IMAX = np.iinfo(np.int32).max


def _layout(n, d, seed, dup=0):
    """(coords (n, d), padded coords_t (D, N_pad) with 3e38 pads); the
    first ``dup`` frames are one repeated point."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0.0, 0.3, size=(n, d)).astype(np.float32)
    c[n // 2:] += np.float32(1.0)
    if dup:
        c[:dup] = c[0]
    n_pad = -(-n // CB) * CB
    ct = np.full((d, n_pad), np.float32(3e38), dtype=np.float32)
    ct[:, :n] = c.T
    return c, ct


def _tiles(n_pad, seed, frac=0.6, upper=True):
    """A random row-major subset of the (upper-triangular) tile grid."""
    rng = np.random.default_rng(seed)
    nrb, ncb = n_pad // RB, n_pad // CB
    act = rng.random((nrb, ncb)) < frac
    if upper:
        act &= pruning.upper_mask(nrb, ncb, RB, CB)
    ti, tj = np.nonzero(act)
    return ti.astype(np.int32), tj.astype(np.int32)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_pops_bidir_matches_pallas(d):
    n = 200
    _, ct = _layout(n, d, seed=d)
    radii2 = np.asarray([0.05, 0.2, 0.6], dtype=np.float32)
    ti, tj = _tiles(ct.shape[1], seed=10 + d)
    rng = np.random.default_rng(d)
    rmask = rng.integers(0, 8, size=len(ti)).astype(np.int32)
    # one no-op pad entry, as the JAX planner emits them
    ti = np.append(ti, ti[-1]).astype(np.int32)
    tj = np.append(tj, -1).astype(np.int32)
    rmask = np.append(rmask, 0).astype(np.int32)
    # the self count (``_add_self_count``) is the engine's, not the kernel's
    want = pk.pops_tiles_sparse_bidir(ct, radii2, np.int32(n), ti, tj, rmask,
                                      row_block=RB, col_block=CB)
    before = dict(kernels.LAUNCHES)
    got = kernels.pops_bidir(torch.from_numpy(ct), torch.from_numpy(radii2),
                             n, torch.from_numpy(ti), torch.from_numpy(tj),
                             torch.from_numpy(rmask), RB, CB)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
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


@pytest.mark.parametrize("d", [1, 3, 4])
def test_pops_bidir_nine_radii_and_ties_match_pallas(d):
    """Nine radii (two launch groups on the card), four of them ties -- the
    squared radius equals a pair's fma-chain d2 -- and one of 0 (only the
    duplicate frames), over the full upper-triangular list with a partial
    rmask whose tie bits are set on every tile."""
    n = 150
    c, ct = _layout(n, d, seed=70 + d, dup=5)
    pairs = ((3, 40), (7, 120), (20, 21), (60, 149))
    radii2 = _tie_radii2(torch.from_numpy(c), pairs,
                         [0.0, 0.02, 0.1, 0.3, 0.8]).numpy()
    ti, tj = _tiles(ct.shape[1], seed=80 + d, frac=1.0)
    rng = np.random.default_rng(d)
    rmask = (rng.integers(0, 1 << 9, size=len(ti)) | 0b1111).astype(np.int32)
    want = np.asarray(pk.pops_tiles_sparse_bidir(
        ct, radii2, np.int32(n), ti, tj, rmask, row_block=RB, col_block=CB))
    args = (torch.from_numpy(ti), torch.from_numpy(tj),
            torch.from_numpy(rmask), RB, CB)
    got = kernels.pops_bidir(torch.from_numpy(ct), torch.from_numpy(radii2),
                             n, *args)
    np.testing.assert_array_equal(want, got.numpy())
    # each tie radius counts its pair: one ulp less counts fewer
    below = np.nextafter(radii2[:4], np.float32(-np.inf))
    fewer = kernels.pops_bidir(torch.from_numpy(ct), torch.from_numpy(below),
                               n, *args).numpy()
    for k, (i, j) in enumerate(pairs):
        assert fewer[k, i] < want[k, i] and fewer[k, j] < want[k, j]


def _nn_inputs(n, d, seed, dup):
    c, ct = _layout(n, d, seed, dup=dup)
    n_pad = ct.shape[1]
    rng = np.random.default_rng(seed)
    fe = rng.random(n).astype(np.float32)
    fe[:dup] = np.float32(0.0)  # the duplicates hold the lowest fe
    fe_pad = np.full(n_pad, np.inf, np.float32)
    fe_pad[:n] = fe
    order = rng.permutation(n).astype(np.int32)
    oid = np.full(n_pad, IMAX, np.int32)
    oid[:n] = order
    return ct, fe_pad, oid


@pytest.mark.parametrize("d", [2, 3, 4])
def test_nn_bidir_matches_pallas(d):
    n = 190
    dup = 16  # frames 0..15 identical: d2 == 0 pairs are never neighbours
    ct, fe_pad, oid = _nn_inputs(n, d, seed=30 + d, dup=dup)
    n_pad = ct.shape[1]
    nrb, ncb = n_pad // RB, n_pad // CB
    rng = np.random.default_rng(40 + d)
    act = (rng.random((nrb, ncb)) < 0.6) & pruning.upper_mask(nrb, ncb,
                                                              RB, CB)
    # rows 0..15 see only their own (all-duplicate) column block, and no
    # upper tile holds that block as columns: no admissible neighbour at
    # all -> (inf, IMAX)
    act[:2] = False
    act[:2, 0] = True
    ti, tj = (a.astype(np.int32) for a in np.nonzero(act))
    want_d, want_j = pk.nn_tiles_sparse_bidir(
        ct, fe_pad.reshape(1, -1), oid.reshape(1, -1), np.int32(n), ti, tj,
        row_block=RB, col_block=CB)
    want_d, want_j = np.asarray(want_d), np.asarray(want_j)
    keys = kernels.nn_keys_init(ct.shape[1], "cpu")
    kernels.nn_bidir(torch.from_numpy(ct), torch.from_numpy(fe_pad),
                     torch.from_numpy(oid), n, torch.from_numpy(ti),
                     torch.from_numpy(tj), keys, RB, CB)
    got_d, got_j = kernels.unpack_keys(keys)
    # keys are indexed by original id; the Pallas output by position
    got_d = got_d.numpy()[:, oid[:n]]
    got_j = got_j.numpy()[:, oid[:n]]
    np.testing.assert_array_equal(want_j[:, :n], got_j)
    np.testing.assert_array_equal(want_d[:, :n], got_d)
    # the duplicates (which also hold the lowest fe) have no neighbour
    assert (got_j[:, :dup] == IMAX).all() and np.isinf(got_d[:, :dup]).all()
    assert np.isfinite(got_d[:, dup:]).any(axis=1).all()


@pytest.mark.parametrize("d", [2, 3, 4])
def test_label_min_bidir_matches_pallas(d):
    n = 210
    _, ct = _layout(n, d, seed=50 + d)
    n_pad = ct.shape[1]
    rng = np.random.default_rng(d)
    labels = np.arange(n_pad, dtype=np.int32)
    labels[:n] = np.minimum(labels[:n], rng.integers(0, n, size=n))
    ti, tj = _tiles(n_pad, seed=60 + d, frac=0.8)
    dirty = (rng.random(len(ti)) < 0.7).astype(np.int32)
    dirty[0] = 0
    n_below, md2 = 170, np.float32(0.08)
    row_p, col_p = pk.label_min_sparse_bidir(
        ct, labels.reshape(1, -1), np.int32(n_below), md2, ti, tj, dirty,
        n_pad, row_block=RB, col_block=CB)
    want = np.minimum(labels, np.minimum(np.asarray(row_p)[0],
                                         np.asarray(col_p)[0]))
    got = kernels.label_min_bidir(
        torch.from_numpy(ct), torch.from_numpy(labels), n_below, md2,
        torch.from_numpy(ti), torch.from_numpy(tj), torch.from_numpy(dirty),
        RB, CB)
    np.testing.assert_array_equal(want, got.numpy())
    assert (want != labels).any()


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is refused:
    the plain version is taken only for CPU tensors."""
    ct = torch.zeros((2, CB), device="meta")
    ti = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.label_min_bidir(ct, torch.zeros(CB, dtype=torch.int32,
                                                device="meta"),
                                4, 0.1, ti, ti, ti, RB, CB)
    with pytest.raises(ValueError):
        kernels.pops_tiles(ct, torch.zeros(1, device="meta"), 4, ti, RB, CB)
    with pytest.raises(ValueError):
        kernels.nn_tiles(ct, torch.zeros((1, CB), device="meta"),
                         torch.zeros((1, CB), dtype=torch.int32,
                                     device="meta"), 4, ti, RB, CB)


# -- on the card ---------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("d,rb,cb", [(2, 8, 16), (4, 128, 4096),
                                     (17, 32, 64)])
def test_cuda_kernels_match_plain(d, rb, cb):
    _need_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(d)
    n = 3 * cb + 37
    n_pad = -(-n // cb) * cb
    c = rng.normal(0.0, 0.3, size=(n, d)).astype(np.float32)
    c[:8] = c[0]
    ct = np.full((d, n_pad), np.float32(3e38), np.float32)
    ct[:, :n] = c.T
    nrb, ncb = n_pad // rb, n_pad // cb
    act = (rng.random((nrb, ncb)) < 0.7) & pruning.upper_mask(nrb, ncb, rb,
                                                              cb)
    ti, tj = (torch.as_tensor(a.astype(np.int32), device=dev)
              for a in np.nonzero(act))
    ct_d = torch.as_tensor(ct, device=dev)
    r2 = torch.tensor([0.01, 0.05, 0.2], device=dev)
    rmask = torch.as_tensor(rng.integers(0, 8, size=len(ti)).astype(np.int32),
                            device=dev)
    kernels.reset_launches()
    got = kernels.pops_bidir(ct_d, r2, n, ti, tj, rmask, rb, cb)
    want = kernels.pops_bidir_plain(ct_d, r2, n, ti, tj, rmask, rb, cb)
    assert torch.equal(got, want)
    fe = torch.full((n_pad,), float("inf"), device=dev)
    fe[:n] = torch.as_tensor(rng.random(n).astype(np.float32), device=dev)
    oid = torch.full((n_pad,), IMAX, dtype=torch.int32, device=dev)
    oid[:n] = torch.as_tensor(rng.permutation(n).astype(np.int32),
                              device=dev)
    k1 = kernels.nn_bidir(ct_d, fe, oid, n, ti, tj,
                          kernels.nn_keys_init(n_pad, dev), rb, cb)
    k2 = kernels.nn_bidir_plain(ct_d, fe, oid, n, ti, tj,
                                kernels.nn_keys_init(n_pad, dev), rb, cb)
    assert torch.equal(k1[:, :n], k2[:, :n])
    labels = torch.arange(n_pad, dtype=torch.int32, device=dev)
    dirty = (torch.rand(len(ti), device=dev) < 0.8).to(torch.int32)
    l1 = kernels.label_min_bidir(ct_d, labels, n - 20, 0.05, ti, tj, dirty,
                                 rb, cb)
    l2 = kernels.label_min_bidir_plain(ct_d, labels, n - 20, 0.05, ti, tj,
                                       dirty, rb, cb)
    assert torch.equal(l1, l2)
    assert kernels.LAUNCHES == {"pops_bidir": 1, "nn_bidir": 1,
                                "label_min_bidir": 1, "pops_sparse": 0,
                                "nn_sparse": 0, "label_min_sparse": 0,
                                "pops_tiles": 0, "nn_tiles": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("d,rb,cb", [(2, 8, 16), (3, 16, 24), (4, 128, 4096),
                                     (17, 32, 64)])
def test_cuda_sparse_kernels_match_plain(d, rb, cb):
    """The three row-side kernels on cross-form inputs (a row set of its
    own, tj = -1 pads, a row-block offset and a dirty subset) against their
    plain versions: exact."""
    _need_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(100 + d)
    n = 3 * cb + 37
    block = int(np.lcm(rb, cb))
    n_pad = -(-n // block) * block
    c = rng.normal(0.0, 0.3, size=(n, d)).astype(np.float32)
    c[:8] = c[0]
    ct = np.full((d, n_pad), np.float32(3e38), np.float32)
    ct[:, :n] = c.T
    off = 2
    rows = np.ascontiguousarray(ct[:, off * rb:off * rb + 5 * rb])
    rows[:, :3] += np.float32(0.01)
    nrb, ncb = rows.shape[1] // rb, n_pad // cb
    ti, tj = np.nonzero(rng.random((nrb, ncb)) < 0.7)
    ti = np.append(ti, ti[-1]).astype(np.int32)
    tj = np.append(tj, -1).astype(np.int32)
    rmask = rng.integers(1, 8, size=len(ti)).astype(np.int32)
    rmask[-1] = 0
    ct_d, rows_d = torch.as_tensor(ct, device=dev), torch.as_tensor(rows,
                                                                    device=dev)
    ti_d, tj_d = torch.as_tensor(ti, device=dev), torch.as_tensor(tj,
                                                                  device=dev)
    r2 = torch.tensor([0.01, 0.05, 0.2], device=dev)
    kernels.reset_launches()
    pargs = (rows_d, ct_d, r2, n, ti_d, tj_d, torch.as_tensor(rmask,
                                                              device=dev),
             rb, cb)
    assert torch.equal(kernels.pops_sparse(*pargs),
                       kernels.pops_sparse_plain(*pargs))
    fe = torch.full((n_pad,), float("inf"), device=dev)
    fe[:n] = torch.as_tensor((rng.integers(0, 5, size=n) / 4.0)
                             .astype(np.float32), device=dev)
    oid = torch.full((n_pad,), IMAX, dtype=torch.int32, device=dev)
    oid[:n] = torch.as_tensor(rng.permutation(n).astype(np.int32), device=dev)
    fe_r = fe[off * rb:off * rb + 5 * rb].contiguous()
    oid_r = oid[off * rb:off * rb + 5 * rb].contiguous()

    def nn(fn):
        return fn(rows_d, fe_r, oid_r, ct_d, fe, oid, n, ti_d, tj_d,
                  kernels.nn_keys_init(n_pad, dev), rb, cb)

    assert torch.equal(nn(kernels.nn_sparse), nn(kernels.nn_sparse_plain))
    labels = torch.arange(n_pad, dtype=torch.int32, device=dev)
    labels[:n] = torch.minimum(labels[:n], torch.as_tensor(
        rng.integers(0, n, size=n).astype(np.int32), device=dev))
    dirty = torch.as_tensor((rng.random(ncb) < 0.7).astype(np.int32),
                            device=dev)
    largs = (rows_d, ct_d, labels, n - 20, 0.05, ti_d, tj_d, off, dirty, rb,
             cb)
    assert torch.equal(kernels.label_min_sparse(*largs),
                       kernels.label_min_sparse_plain(*largs))
    assert (kernels.label_min_sparse(*largs) < IMAX).any()
    assert kernels.LAUNCHES == {"pops_bidir": 0, "nn_bidir": 0,
                                "label_min_bidir": 0, "pops_sparse": 1,
                                "nn_sparse": 1, "label_min_sparse": 2,
                                "pops_tiles": 0, "nn_tiles": 0}


def _bidir_case(d, rb, cb, seed):
    """Coordinates with duplicate groups (d2 = 0, and equal d2 to the
    members of a group), n_valid and n_below inside a tile, real frames
    past n_valid, fe with ties, and an upper-triangular tile list."""
    rng = np.random.default_rng(seed)
    n = 2 * max(rb, cb) + cb // 2 + 19
    block = int(np.lcm(rb, cb))
    n_pad = -(-(n + 7) // block) * block
    c = rng.normal(0.0, 0.3, size=(n_pad, d)).astype(np.float32)
    c[n // 2:] += np.float32(0.8)
    c[:6] = c[0]
    c[6:9] = c[n - 1]
    c[40:44] = c[n // 2]
    ct = np.ascontiguousarray(c.T)  # frames past n_valid are real here
    nrb, ncb = n_pad // rb, n_pad // cb
    act = (rng.random((nrb, ncb)) < 0.8) & pruning.upper_mask(nrb, ncb, rb,
                                                              cb)
    ti, tj = np.nonzero(act)
    fe = (rng.integers(0, 6, size=n_pad) / 4.0).astype(np.float32)
    oid = rng.permutation(n_pad).astype(np.int32)
    return n, ct, ti.astype(np.int32), tj.astype(np.int32), fe, oid


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 4, 8, 16, 17])
@pytest.mark.parametrize("rb,cb", [(128, 4096), (32, 256), (64, 64)])
def test_cuda_redesigned_bidir_kernels_match_plain(d, rb, cb):
    """The micro-tiled nn_bidir and label_min_bidir against their plain
    versions (D = 17 takes the runtime-D instance): keys exact (ids, and
    distances bit for bit) after two accumulating sweeps, the second on
    a buffer that already holds the first's keys; swept labels exact over
    a partly dirty list."""
    _need_cuda()
    dev = torch.device("cuda")
    n, ct, ti, tj, fe, oid = _bidir_case(d, rb, cb, seed=7 * d + rb)
    n_pad = ct.shape[1]
    put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    ct_d, fe_d, oid_d, ti_d, tj_d = map(put, (ct, fe, oid, ti, tj))
    half = len(ti) // 2
    kernels.reset_launches()
    keys = {}
    for name, fn in (("kernel", kernels.nn_bidir),
                     ("plain", kernels.nn_bidir_plain)):
        k = kernels.nn_keys_init(n_pad, dev)
        fn(ct_d, fe_d, oid_d, n, ti_d[:half], tj_d[:half], k, rb, cb)
        fn(ct_d, fe_d, oid_d, n, ti_d, tj_d, k, rb, cb)
        keys[name] = k
    assert torch.equal(keys["kernel"], keys["plain"])
    d2, ids = kernels.unpack_keys(keys["plain"][:, oid[:n]])
    assert bool((d2[0] == 0).sum() == 0) and bool(torch.isfinite(d2).any())
    labels = put(np.minimum(np.arange(n_pad), np.random.default_rng(d)
                            .integers(0, n_pad, n_pad)).astype(np.int32))
    dirty = put((np.random.default_rng(rb).random(len(ti)) < 0.6)
                .astype(np.int32))
    n_below = n - 13
    md2 = np.float32(0.02 * d)
    largs = (ct_d, labels, n_below, md2, ti_d, tj_d, dirty, rb, cb)
    got = kernels.label_min_bidir(*largs)
    want = kernels.label_min_bidir_plain(*largs)
    assert torch.equal(got, want)
    assert bool((want != labels).any())
    assert kernels.LAUNCHES["nn_bidir"] == 2
    assert kernels.LAUNCHES["label_min_bidir"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 4, 8, 16, 17])
@pytest.mark.parametrize("rb,cb", [(128, 4096), (32, 256), (64, 64)])
def test_cuda_redesigned_pops_bidir_matches_plain(d, rb, cb):
    """The micro-tiled pops_bidir against its plain version with 1, 2, 3, 8
    and 9 radii (9: two launches; every radius-bucket instance), a
    partial rmask, tie radii (squares equal to pairs' d2), diagonal tiles,
    n_valid inside a tile, real frames past it and duplicate frames
    (d2 = 0): counts exact."""
    _need_cuda()
    dev = torch.device("cuda")
    n, ct, ti, tj, _, _ = _bidir_case(d, rb, cb, seed=11 * d + rb)
    ct_d, ti_d, tj_d = (torch.as_tensor(a, device=dev) for a in (ct, ti, tj))
    x = ct_d[:, :n].T
    radii2 = _tie_radii2(x, ((1, n - 1), (5, n // 2), (10, 11)),
                         [0.0, 0.002 * d, 0.01 * d, 0.04 * d, 0.1 * d,
                          0.4 * d])
    rng = np.random.default_rng(d + rb)
    kernels.reset_launches()
    for k in (1, 2, 3, 8, 9):
        rmask = rng.integers(0, 1 << k, size=len(ti)).astype(np.int32)
        rmask[::7] = (1 << k) - 1
        args = (ct_d, radii2[:k].contiguous(), n, ti_d, tj_d,
                torch.as_tensor(rmask, device=dev), rb, cb)
        got = kernels.pops_bidir(*args)
        assert torch.equal(got, kernels.pops_bidir_plain(*args)), k
    assert bool((got[:, :n] > 1).any())
    assert kernels.LAUNCHES["pops_bidir"] == 6


# squared radii at the edges of the kernels' one-fma count: below 2^-100
# the exact compare takes over (the first set), above it the fma decides
# (the second); -1 and NaN count nothing, inf and FLT_MAX count everything
# (inf: pads included)
EDGE_RADII2 = {
    "exact": [0.0, 1e-35, 2.0 ** -100, -1.0, float("nan"), float("inf"),
              float(np.finfo(np.float32).max)],
    "fma": [2.0 ** -100, 2.0 ** -99.5, -1.0, float("nan"), float("inf"),
            float(np.finfo(np.float32).max), 1e30],
}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 17])
@pytest.mark.parametrize("which", sorted(EDGE_RADII2))
def test_cuda_pops_bidir_edge_radii_match_plain(d, which):
    """pops_bidir with radii at the edges of its one-fma count, and tie
    radii, against its plain version: counts exact."""
    _need_cuda()
    dev = torch.device("cuda")
    n, ct, ti, tj, _, _ = _bidir_case(d, 64, 256, seed=5 * d)
    ct_d, ti_d, tj_d = (torch.as_tensor(a, device=dev) for a in (ct, ti, tj))
    radii2 = _tie_radii2(ct_d[:, :n].T, ((2, n - 3),), EDGE_RADII2[which])
    rmask = torch.full((len(ti),), 255, dtype=torch.int32, device=dev)
    args = (ct_d, radii2, n, ti_d, tj_d, rmask, 64, 256)
    got = kernels.pops_bidir(*args)
    assert torch.equal(got, kernels.pops_bidir_plain(*args))


def _sparse_case(d, rb, cb, seed):
    """Cross-form inputs of a row-side kernel: columns with duplicates and
    n_valid inside a column block; rows of their own (copies of columns
    first, then jittered frames, then a pad-only row block); a row-major
    tile list of the grid with tj = -1 entries. Returns (n, rows_t,
    cols_t, ti, tj) as numpy arrays."""
    rng = np.random.default_rng(seed)
    n = 3 * cb + cb // 2 + 5
    c = rng.normal(0.0, 0.3, size=(n, d)).astype(np.float32)
    c[:8] = c[0]
    cols_t = np.full((d, -(-n // cb) * cb), np.float32(3e38), np.float32)
    cols_t[:, :n] = c.T
    rows_t = np.full((d, 6 * rb), np.float32(3e38), np.float32)
    rows_t[:, :5 * rb] = (c[rng.integers(0, n, size=5 * rb)]
                          + rng.normal(0.0, 0.02, size=(5 * rb, d))).T
    rows_t[:, :3] = c[[0, 1, n - 1]].T
    act = rng.random((6, cols_t.shape[1] // cb)) < 0.7
    act[0] = True
    ti, tj = np.nonzero(act)
    ti = np.append(ti, [0, 5]).astype(np.int32)
    tj = np.append(tj, [-1, -1]).astype(np.int32)
    return n, rows_t, cols_t, ti, tj


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 4, 8, 16, 17])
@pytest.mark.parametrize("rb,cb", [(128, 4096), (32, 256), (64, 64), (16, 24)])
def test_cuda_redesigned_pops_sparse_matches_plain(d, rb, cb):
    """The micro-tiled pops_sparse against its plain version with 1, 3, 8
    and 9 radii (9: two launches), tie radii (squares equal to pairs' d2)
    and r = 0, a random partial rmask per tile with rmask = 0 entries, tj
    = -1 entries (one with a non-zero rmask), a row set of its own with a
    pad-only row block and n_valid inside a column block: counts exact."""
    _need_cuda()
    dev = torch.device("cuda")
    n, rows_t, cols_t, ti, tj = _sparse_case(d, rb, cb, seed=500 + d + rb)
    put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    rows_d, ct_d, ti_d, tj_d = map(put, (rows_t, cols_t, ti, tj))
    x = torch.cat([rows_d.T, ct_d.T])
    r_pad = rows_t.shape[1]
    radii2 = _tie_radii2(x, ((0, r_pad + 3), (1, r_pad + n - 2),
                             (2, r_pad + 40)),
                         [0.0, 0.002 * d, 0.01 * d, 0.04 * d, 0.1 * d,
                          0.4 * d])
    rng = np.random.default_rng(d + rb)
    kernels.reset_launches()
    for k in (1, 3, 8, 9):
        rmask = rng.integers(0, 1 << k, size=len(ti)).astype(np.int32)
        rmask[::7] = (1 << k) - 1
        rmask[-1] = 1  # tj = -1 gates it off whatever its rmask
        args = (rows_d, ct_d, radii2[:k].contiguous(), n, ti_d, tj_d,
                put(rmask), rb, cb)
        got = kernels.pops_sparse(*args)
        assert torch.equal(got, kernels.pops_sparse_plain(*args)), k
        assert got[:, 5 * rb:].eq(0).all()
    assert bool((got[:, :rb] > 1).any())
    assert kernels.LAUNCHES["pops_sparse"] == 5


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 17])
@pytest.mark.parametrize("which", sorted(EDGE_RADII2))
def test_cuda_pops_sparse_edge_radii_match_plain(d, which):
    """pops_sparse with radii at the edges of its one-fma count and a tie
    radius under a partial rmask (r = 0 takes the exact instance only in
    the tiles whose rmask turns it on), on a row set with a pad-only row
    block (d2 = inf: inf counts it, FLT_MAX does not), against its plain
    version: counts exact."""
    _need_cuda()
    dev = torch.device("cuda")
    n, rows_t, cols_t, ti, tj = _sparse_case(d, 32, 64, seed=600 + d)
    put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    rows_d, ct_d = put(rows_t), put(cols_t)
    radii2 = _tie_radii2(torch.cat([rows_d.T, ct_d.T]),
                         ((0, rows_t.shape[1] + 9),), EDGE_RADII2[which])
    rmask = np.random.default_rng(d).integers(0, 256, size=len(ti))
    rmask[::3] = 255
    args = (rows_d, ct_d, radii2, n, put(ti), put(tj),
            put(rmask.astype(np.int32)), 32, 64)
    got = kernels.pops_sparse(*args)
    assert torch.equal(got, kernels.pops_sparse_plain(*args))


def _row_side_case(d, rb, cb, seed):
    """Cross-form inputs of the redesigned row-side kernels: columns with
    duplicates (d2 = 0), quantised fe (ties), ids and n_valid inside a
    column block; seven row blocks of their own (R_pad != N_pad), jittered
    copies of columns with exact copies first, the last block pads; rows
    with id INT32_MAX (the pad block and a few others), fe ties and one row
    below every column; a row-major list with repeats and tj = -1 entries.
    Returns a dict of numpy arrays and ints."""
    rng = np.random.default_rng(seed)
    n = 3 * cb + cb // 2 + 5
    n_pad = -(-n // cb) * cb
    c = rng.normal(0.0, 0.3, size=(n, d)).astype(np.float32)
    c[:8] = c[0]
    cols_t = np.full((d, n_pad), np.float32(3e38), np.float32)
    cols_t[:, :n] = c.T
    r_real = 6 * rb
    rows_t = np.full((d, 7 * rb), np.float32(3e38), np.float32)
    rows_t[:, :r_real] = (c[rng.integers(0, n, size=r_real)]
                          + rng.normal(0.0, 0.02, size=(r_real, d))).T
    rows_t[:, :3] = c[[0, 1, n - 1]].T
    fe_cols = np.full(n_pad, np.inf, np.float32)
    fe_cols[:n] = rng.integers(0, 5, size=n) / np.float32(4.0)
    oid = np.full(n_pad, IMAX, np.int32)
    oid[:n] = rng.permutation(n)
    fe_rows = np.full(7 * rb, np.inf, np.float32)
    fe_rows[:r_real] = rng.integers(0, 5, size=r_real) / np.float32(4.0)
    fe_rows[4] = -1.0  # no lower-fe neighbour
    oid_rows = np.full(7 * rb, IMAX, np.int32)
    oid_rows[:r_real] = rng.integers(0, n_pad, size=r_real)
    oid_rows[[5, rb + 1, 3 * rb + 2]] = IMAX
    ti, tj = np.nonzero(rng.random((7, n_pad // cb)) < 0.7)
    ti = np.append(ti, [ti[0], 0, 6]).astype(np.int32)
    tj = np.append(tj, [tj[0], -1, -1]).astype(np.int32)
    assert rows_t.shape[1] != n_pad
    return dict(n=n, rows_t=rows_t, cols_t=cols_t, fe_rows=fe_rows,
                oid_rows=oid_rows, fe_cols=fe_cols, oid=oid, ti=ti, tj=tj)


def _shuffled(ti, tj, seed):
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(len(ti)),
                           device=ti.device)
    return ti[perm], tj[perm]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 4, 8, 16, 17])
@pytest.mark.parametrize("rb,cb", [(128, 4096), (32, 256), (64, 64), (16, 24)])
def test_cuda_redesigned_nn_sparse_matches_plain(d, rb, cb):
    """The micro-tiled nn_sparse against its plain version on cross-form
    inputs (_row_side_case): a first call into a fresh buffer, then a
    second call, on the list shuffled, into the buffer that holds the
    first call's keys (the seeded filter); keys exact (ids, and distances
    bit for bit) after each."""
    _need_cuda()
    dev = torch.device("cuda")
    case = _row_side_case(d, rb, cb, seed=900 + 3 * d + rb)
    t = {k: torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray)
         else v for k, v in case.items()}
    n_pad = case["cols_t"].shape[1]
    first = (t["ti"][::3].contiguous(), t["tj"][::3].contiguous())
    second = _shuffled(t["ti"], t["tj"], seed=d + rb)
    kernels.reset_launches()
    keys = {}
    for name, fn in (("kernel", kernels.nn_sparse),
                     ("plain", kernels.nn_sparse_plain)):
        k = kernels.nn_keys_init(n_pad, dev)
        for ti, tj in (first, second):
            fn(t["rows_t"], t["fe_rows"], t["oid_rows"], t["cols_t"],
               t["fe_cols"], t["oid"], t["n"], ti, tj, k, rb, cb)
            keys.setdefault(name, []).append(k.clone())
    for got, want in zip(keys["kernel"], keys["plain"]):
        assert torch.equal(got, want)
    assert not torch.equal(keys["plain"][0], keys["plain"][1])
    d2, _ = kernels.unpack_keys(keys["plain"][1])
    assert bool(torch.isfinite(d2).any()) and bool((d2 != 0).all())
    assert kernels.LAUNCHES["nn_sparse"] == 2


def _components(ct, n_below, md2, cb):
    """Fixpoint labels of the graph d2 < md2 over the first n_below frames
    of ct (each frame its component's least position, arange above),
    through the plain row-side sweep with pointer jumping."""
    n_pad = ct.shape[1]
    ncb = n_pad // cb
    ti = torch.arange(ncb, dtype=torch.int32, device=ct.device)
    ti, tj = ti.repeat_interleave(ncb), ti.repeat(ncb)
    dirty = torch.ones(ncb, dtype=torch.int32, device=ct.device)
    labels = torch.arange(n_pad, dtype=torch.int32, device=ct.device)
    while True:
        prop = kernels.label_min_sparse_plain(ct, ct, labels, n_below, md2,
                                              ti, tj, 0, dirty, cb, cb)
        new = torch.minimum(labels, prop)
        while not torch.equal(new[new.long()], new):
            new = new[new.long()]
        if torch.equal(new, labels):
            return labels
        labels = new


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 4, 8, 16, 17])
@pytest.mark.parametrize("rb,cb", [(128, 4096), (32, 256), (64, 64), (16, 24)])
def test_cuda_redesigned_label_min_sparse_matches_plain(d, rb, cb):
    """The micro-tiled label_min_sparse against its plain version on
    cross-form inputs (_row_side_case) with a row-block offset, n_below
    inside a row block and a column block, and a partial dirty set: on
    arange-like labels and on converged labels (a finished fixpoint, where
    the step skip fires), each list also shuffled; proposals exact."""
    _need_cuda()
    dev = torch.device("cuda")
    case = _row_side_case(d, rb, cb, seed=700 + 3 * d + rb)
    rows_d, ct_d, ti, tj = (torch.as_tensor(case[k], device=dev)
                            for k in ("rows_t", "cols_t", "ti", "tj"))
    n, n_pad = case["n"], case["cols_t"].shape[1]
    off = 2
    n_below = min(n - 3, (off + 3) * rb + rb // 2 + 1)
    md2 = np.float32(0.02 * d)
    rng = np.random.default_rng(d + rb)
    dirty = torch.as_tensor((rng.random(n_pad // cb) < 0.7).astype(np.int32),
                            device=dev)
    dirty[0] = 1
    mixed = torch.as_tensor(np.minimum(np.arange(n_pad), rng.integers(
        0, n_pad, n_pad)).astype(np.int32), device=dev)
    converged = _components(ct_d, n_below, md2, cb)
    assert bool((converged[:n_below] != torch.arange(n_below,
                                                     device=dev)).any())
    kernels.reset_launches()
    for labels in (mixed, converged):
        want = kernels.label_min_sparse_plain(rows_d, ct_d, labels, n_below,
                                              md2, ti, tj, off, dirty, rb,
                                              cb)
        for lti, ltj in ((ti, tj), _shuffled(ti, tj, seed=d)):
            got = kernels.label_min_sparse(rows_d, ct_d, labels, n_below,
                                           md2, lti, ltj, off, dirty, rb, cb)
            assert torch.equal(got, want)
        assert bool((want < IMAX).any())
    assert kernels.LAUNCHES["label_min_sparse"] == 4
