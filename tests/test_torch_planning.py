"""The port's planning equals the JAX package's: frame orders, padded
layouts, the copied numpy helpers, and the sets of real tiles each sweep
visits (rmask and dirty flags included)."""

import numpy as np
import pytest

from clustering_tpu.models import density as jdensity
from clustering_tpu.ops import density as jdops
from clustering_tpu.ops import engine as jengine
from clustering_tpu.ops import neighbors as jnops
from clustering_tpu.ops import pruning as jpruning
from clustering_tpu.ops import screening as jscreening
from clustering_tpu.utils import textio_native
from clustering_tpu_torch.models import density as tdensity
from clustering_tpu_torch.ops import density as tdops
from clustering_tpu_torch.ops import engine as tengine
from clustering_tpu_torch.ops import neighbors as tnops
from clustering_tpu_torch.ops import pruning as tpruning
from clustering_tpu_torch.ops import screening as tscreening

RB, CB = 8, 16


def _blobs(n, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(0.0, 0.15, size=(n // 2, d))
    b = rng.normal(1.0, 0.2, size=(n - n // 2, d))
    c = np.concatenate([a, b])
    return c[rng.permutation(n)].astype(np.float32)


def _dedupe(ti, tj):
    """Flat tile list of a stacked, repeat-padded JAX list."""
    ti = np.asarray(ti).reshape(-1)
    tj = np.asarray(tj).reshape(-1)
    keep = np.ones(len(ti), dtype=bool)
    keep[1:] = (ti[1:] != ti[:-1]) | (tj[1:] != tj[:-1])
    return ti[keep], tj[keep]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_morton_order_equals_reference(monkeypatch, native, d):
    coords = _blobs(300, d, seed=d).astype(np.float64) * 3.0
    if not native:
        monkeypatch.setattr(textio_native, "morton_order_pad",
                            lambda *a, **k: None)
    np.testing.assert_array_equal(
        tpruning.morton_order(coords),
        jpruning.morton_order(coords.astype(np.float32)))


@pytest.mark.parametrize("d", [2, 3, 4])
def test_bbox_helpers_equal_reference(d):
    c = _blobs(256, d, seed=10 + d)
    for fn in ("block_bboxes",):
        for a, b in zip(getattr(tpruning, fn)(c, RB),
                        getattr(jpruning, fn)(c, RB)):
            np.testing.assert_array_equal(a, b)
    rmin, rmax = jpruning.block_bboxes(c, RB)
    cmin, cmax = jpruning.block_bboxes(c, CB)
    want = jpruning.bbox_dist2(rmin, rmax, cmin, cmax)
    np.testing.assert_array_equal(
        tpruning.bbox_dist2(rmin, rmax, cmin, cmax), want)
    # the device bound: same arithmetic up to fma contraction, and a valid
    # lower bound either way
    import torch
    got = tpruning.bbox_d2(torch.from_numpy(np.ascontiguousarray(c.T)), RB,
                           CB).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    ref_dev = np.asarray(jpruning.bbox_d2_device(c.T, RB, CB))
    np.testing.assert_allclose(got, ref_dev, rtol=1e-6)


def test_mask_helpers_equal_reference():
    rng = np.random.default_rng(0)
    for nrb, ncb in ((16, 8), (32, 16)):
        act = rng.random((nrb, ncb)) < 0.3
        np.testing.assert_array_equal(
            tpruning.bidir_closure(act, RB, CB),
            jpruning.bidir_closure(act, RB, CB))
        for hw in (16, 40):
            np.testing.assert_array_equal(
                tpruning.band_mask(nrb, ncb, RB, CB, hw),
                jpruning.band_mask(nrb, ncb, RB, CB, hw))
        ti, tj = tpruning.tile_list(act)
        wi, wj = jpruning.tile_list(act)
        n = int(act.sum())
        np.testing.assert_array_equal(ti, wi.reshape(-1)[:n])
        np.testing.assert_array_equal(tj, wj.reshape(-1)[:n])
    assert tpruning.tile_list(np.zeros((4, 2), bool)) is None


def test_numpy_helpers_equal_reference():
    rng = np.random.default_rng(1)
    pops = rng.integers(1, 500, size=400)
    np.testing.assert_array_equal(tdops.free_energies(pops),
                                  jdops.free_energies(pops))
    nh_d = rng.random(400).astype(np.float32)
    assert tnops.compute_sigma2(nh_d) == jnops.compute_sigma2(nh_d)
    fe = jdops.free_energies(pops)
    np.testing.assert_array_equal(tdensity.sorted_fe_order(fe),
                                  jdensity.sorted_fe_order(fe))
    clust = rng.integers(0, 6, size=400)
    nhhd = np.where(np.arange(400) > 0, rng.integers(0, 400, size=400), 0)
    nhhd = np.minimum(nhhd, np.arange(400))  # acyclic pointer chain
    np.testing.assert_array_equal(
        tdensity.assign_low_density_frames(clust, nhhd, fe),
        jdensity.assign_low_density_frames(clust, nhhd, fe))
    np.testing.assert_array_equal(tdensity.sorted_cluster_names(clust),
                                  jdensity.sorted_cluster_names(clust))
    order = jdensity.sorted_fe_order(fe)
    for nb in (0, 100, 400):
        np.testing.assert_array_equal(
            tdensity.normalized_cluster_names(nb, clust, order),
            jdensity.normalized_cluster_names(nb, clust, order))
    for v in (0.1, 0.25, 0.123, 1.0, 3.07):
        assert tdensity.has_2_digits(v) == jdensity.has_2_digits(v)
    for params in ([0.3, 0.3, 1.2], [-1], [0.1, 0.2], [0.5]):
        a = tdensity._parse_threshold_series(params, fe)
        b = jdensity._parse_threshold_series(params, fe)
        assert a[:3] == b[:3] and a[3] == b[3]
    for bad in ([0.1, 0.1, 1.0, 2.0], [0.123, 0.1, 1.0]):
        with pytest.raises(ValueError):
            tdensity._parse_threshold_series(bad, fe)


@pytest.mark.parametrize("d", [2, 3])
def test_engine_layouts_equal_reference(d):
    coords = _blobs(300, d, seed=20 + d)
    te = tengine.DensityEngine(coords, RB, CB, device="cpu")
    je = jengine.DensityEngine(coords, RB, CB, backend="pallas")
    assert te.n_pad == je.n_pad
    for name in ("dim0", "morton"):
        t_order, t_pad = te._layout(name), te.coords_t(name).numpy().T
        j_order, j_pad = je._padded(name)
        np.testing.assert_array_equal(t_order, j_order)
        np.testing.assert_array_equal(t_pad, j_pad)
        np.testing.assert_array_equal(te.oid(name).numpy(),
                                      np.asarray(je._oid_dev(name))[0])


@pytest.mark.parametrize("radii", [[0.2], [0.1, 0.3, 0.5]])
def test_pops_tiles_equal_reference(radii):
    coords = _blobs(320, 3, seed=31)
    te = tengine.DensityEngine(coords, RB, CB, device="cpu")
    je = jengine.DensityEngine(coords, RB, CB, backend="pallas")
    name, ti, tj, rmask = te.pops_plan(radii)
    r_max2 = np.float32(max(radii)) * np.float32(max(radii))
    assert name == je._best_sort(r_max2)
    planes = jpruning.active_masks_device(
        je._d2b_dev(name),
        [r_max2] + [np.float32(r) * np.float32(r) for r in radii])
    nrb, ncb = planes[0].shape
    active = planes[0] & jpruning.upper_tri_device(planes[0], RB,
                                                   CB).__array__()
    wi, wj = jpruning.tile_list(active, pad_mode="noop")
    w_rm = je._pops_rmask(wi, wj, planes, len(radii), True)
    real = wj.reshape(-1) >= 0
    np.testing.assert_array_equal(ti, wi.reshape(-1)[real])
    np.testing.assert_array_equal(tj, wj.reshape(-1)[real])
    np.testing.assert_array_equal(rmask, w_rm.reshape(-1)[real])
    assert len(ti) < nrb * ncb  # pruning is active on this data


def test_nn_plan_equals_reference():
    coords = _blobs(400, 3, seed=41)
    pops = jdops.populations(coords, [0.3], backend="xla",
                             row_block=RB, col_block=CB)[0.3]
    fe = jdops.free_energies(pops)
    te = tengine.DensityEngine(coords, RB, CB, device="cpu")
    je = jengine.DensityEngine(coords, RB, CB, backend="pallas")
    bb = tengine.NN_BAND_BLOCKS
    te.nearest_neighbors(fe)
    je.nearest_neighbors(fe, band_blocks=bb, tier_qs=None)
    ts, js = te.last_stats["nn"], je.last_stats["nn"]
    assert ts["band_tiles"] > 0
    assert ts["order"] == js["order"]
    assert ts["band_tiles"] == js["band_tiles"]
    assert ts["phase2_tiles"] == js["phase2_tiles"]
    band, band_eff = te.nn_band_mask()
    nrb, ncb = band.shape
    np.testing.assert_array_equal(
        band_eff, jpruning.bidir_closure(
            jpruning.band_mask(nrb, ncb, RB, CB, bb * CB), RB, CB))


def test_screening_tiles_and_layout_equal_reference():
    coords = _blobs(500, 2, seed=51)
    pops = jdops.populations(coords, [0.3], backend="xla",
                             row_block=RB, col_block=CB)[0.3]
    fe = jdops.free_energies(pops)
    thresholds = [np.float32(t) for t in np.quantile(fe, [0.2, 0.5, 0.9])]
    ts = tscreening.ThresholdSeriesScreener(coords, fe, thresholds, RB, CB,
                                            device="cpu")
    js = jscreening.ThresholdSeriesScreener(coords, fe, thresholds, RB, CB,
                                            backend="pallas")
    np.testing.assert_array_equal(ts.order, js.order)
    np.testing.assert_array_equal(ts.n_below_per_band, js.n_below_per_band)
    md2 = np.float32(0.02)
    prev = 0
    for nb in ts.n_below_per_band:
        nb = int(nb)
        assert ts.engine.union_size(nb) == js.engine._union_size(nb)
        for row_lo in (0, prev):
            got = ts.engine.tile_list(row_lo, nb, md2)
            want = js.engine._tile_list_locked(row_lo, nb, md2,
                                               triangular=True)
            if want is None:
                assert got is None
                continue
            wi, wj = _dedupe(*want)
            np.testing.assert_array_equal(got[0], wi)
            np.testing.assert_array_equal(got[1], wj)
        prev = nb


def test_union_rebase_equals_reference():
    import torch
    rng = np.random.default_rng(7)
    n = 256
    lab_in = np.minimum(np.arange(n), rng.integers(0, n, size=n))
    lab_in = lab_in[lab_in]  # labels point at positions <= themselves
    lab_cur = np.minimum(lab_in, rng.integers(0, n, size=n))
    want = np.asarray(jscreening.union_rebase(lab_in.astype(np.int32),
                                              lab_cur.astype(np.int32)))
    got = tscreening.union_rebase(torch.from_numpy(lab_in.astype(np.int32)),
                                  torch.from_numpy(lab_cur.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
