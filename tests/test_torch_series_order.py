"""The series screener's frame order: a stable partition of the Morton
order by threshold band, the order handed in (the density engine's) or
computed, equal element for element to the (band, Morton rank) lexsort,
and the series ranks, naming positions and band counts that follow from
it. Free energies repeat (ties among frames and at the thresholds
themselves), one band is empty, N is no multiple of the blocks, and the
thresholds number 2 to 300 (the band's type one byte wide or two)."""

import numpy as np
import pytest

from clustering_tpu_torch.ops import engine as tengine
from clustering_tpu_torch.ops import pruning
from clustering_tpu_torch.ops import screening as tscreening

RB, CB = 8, 16


def _inputs(n, n_thresholds):
    """(coords, fe, thresholds): fe drawn from the thresholds, the
    midpoints between them and one value beyond each end, none in
    (thresholds[0], thresholds[1]], so that band 1 is empty."""
    rng = np.random.default_rng(1000 * n + n_thresholds)
    coords = rng.normal(size=(n, 3)).astype(np.float32)
    thr = np.cumsum(rng.uniform(0.05, 0.2, n_thresholds)).astype(np.float32)
    mids = ((thr[:-1] + thr[1:]) / 2).astype(np.float32)
    pool = np.concatenate([thr[:1], thr[2:], mids[1:],
                           [thr[0] - 1, thr[-1] + 1]]).astype(np.float32)
    fe = rng.choice(pool, n)
    return coords, fe, [np.float32(t) for t in thr]


@pytest.mark.parametrize("handed_in", [False, True],
                         ids=["computed", "handed_in"])
@pytest.mark.parametrize("n_thresholds", [2, 5, 130, 300])
@pytest.mark.parametrize("n", [1237, 2048])
def test_series_order_is_the_band_morton_lexsort(n, n_thresholds,
                                                 handed_in):
    coords, fe, thresholds = _inputs(n, n_thresholds)
    mo = pruning.morton_order(coords)
    morton_order = None
    if handed_in:
        eng = tengine.DensityEngine(coords, RB, CB, device="cpu")
        assert eng.layout_order("morton") is None
        eng._layout("morton")
        morton_order = eng.layout_order("morton")
        np.testing.assert_array_equal(morton_order, mo)
    series = tscreening.ThresholdSeriesScreener(
        coords, fe, thresholds, RB, CB, device="cpu",
        morton_order=morton_order)

    band = np.searchsorted(thresholds, fe, side="left")
    order = np.lexsort((np.argsort(mo, kind="stable"), band))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    np.testing.assert_array_equal(series.order, order)
    np.testing.assert_array_equal(series._series_rank, rank)
    np.testing.assert_array_equal(series._fe_asc_pos,
                                  rank[np.argsort(fe, kind="stable")])
    per_band = np.cumsum(np.bincount(band, minlength=n_thresholds + 1))
    np.testing.assert_array_equal(series.n_below_per_band,
                                  per_band[:n_thresholds])
    assert series.n_below_per_band[1] == series.n_below_per_band[0]
    assert np.unique(fe).size < n
    np.testing.assert_array_equal(
        series.engine.coords_t[:, :n].numpy().T, coords[order])


def test_a_morton_order_of_other_frames_raises():
    coords, fe, thresholds = _inputs(100, 3)
    with pytest.raises(ValueError, match="99 frames"):
        tscreening.ThresholdSeriesScreener(
            coords, fe, thresholds, RB, CB, device="cpu",
            morton_order=np.arange(99))
