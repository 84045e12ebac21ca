"""The port's device planning against the JAX package's device planners
and against the numpy (host) planners.

Every stage plans on the device, on both routes; the numpy planners are
the reference. Each device planner must emit the numpy planner's tile set
in the same row-major order, so that the plan never changes a result
(``tests/test_device_plan.py`` pins the same invariant for the JAX
package). All comparisons are exact, except the nearest neighbour
distances against the JAX engine, which recomputes them with XLA's
arithmetic (1 ulp, ``tests/test_torch_density.py``).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clustering_tpu.ops import density as jdops
from clustering_tpu.ops import engine as jengine
from clustering_tpu.ops import neighbors as jnops
from clustering_tpu.ops import pruning as jpruning
from clustering_tpu.ops import screening as jscreening
from clustering_tpu_torch.ops import engine as tengine
from clustering_tpu_torch.ops import kernels as tkernels
from clustering_tpu_torch.ops import pruning as tpruning
from clustering_tpu_torch.ops import screening as tscreening
from clustering_tpu_torch.ops.density import free_energies
from clustering_tpu_torch.ops.neighbors import compute_sigma2
from clustering_tpu_torch.utils import logger as tlogger

RB, CB = 8, 16
PS = [(0.0, 0), (1.0, 1), (0.07, 2), (0.5, 3), (0.93, 4)]
# the JAX package's switch of its own device planners
JAX_DEVICE_PLAN = "CLUSTERING_TPU_DEVICE_PLAN"


def _rand_mask(nrb, ncb, p, seed):
    rng = np.random.default_rng(seed)
    return rng.random((nrb, ncb)) < p


def _dedupe(ti, tj):
    """Flat tile list of a stacked, repeat-padded JAX list."""
    ti = np.asarray(ti).reshape(-1)
    tj = np.asarray(tj).reshape(-1)
    keep = np.ones(len(ti), dtype=bool)
    keep[1:] = (ti[1:] != ti[:-1]) | (tj[1:] != tj[:-1])
    return ti[keep], tj[keep]


def _assert_ulp_close(a, b, ulps=1):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    assert np.abs(a - b).max() <= ulps


# -- the planners ---------------------------------------------------------------

@pytest.mark.parametrize("p,seed", PS)
def test_bidir_closure_device(p, seed):
    ncb, span = 12, CB // RB
    m = _rand_mask(ncb * span, ncb, p, seed)
    got = tpruning.bidir_closure_device(torch.from_numpy(m), RB, CB).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jpruning.bidir_closure_device(jnp.asarray(m), RB,
                                                      CB)))
    np.testing.assert_array_equal(got, tpruning.bidir_closure(m, RB, CB))


def test_bidir_closure_device_rejects_a_ragged_grid():
    with pytest.raises(ValueError):
        tpruning.bidir_closure_device(torch.ones(8, 4, dtype=torch.bool),
                                      8, 12)


@pytest.mark.parametrize("hw_blocks", [1, 3, 7])
def test_band_mask_device(hw_blocks):
    nrb, ncb = 64, 32
    got = tpruning.band_mask_device(nrb, ncb, RB, CB, hw_blocks * CB,
                                    "cpu").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jpruning.band_mask_device(nrb, ncb, RB, CB,
                                                  hw_blocks * CB)))
    np.testing.assert_array_equal(
        got, tpruning.band_mask(nrb, ncb, RB, CB, hw_blocks * CB))


def test_band_mask_device_exact_past_float32():
    """Frame positions past 2^24, where float32 iotas would round: the
    int64 arithmetic still equals the host's float64 mask."""
    nrb, ncb, rb, cb = 1 << 12, 1 << 6, 1 << 13, 1 << 19
    got = tpruning.band_mask_device(nrb, ncb, rb, cb, 4 * cb, "cpu")
    np.testing.assert_array_equal(
        got.numpy(), tpruning.band_mask(nrb, ncb, rb, cb, 4 * cb))


@pytest.mark.parametrize("p,seed", PS)
def test_upper_tri_device(p, seed):
    m = _rand_mask(32, 16, p, seed)
    got = tpruning.upper_tri_device(torch.from_numpy(m), RB, CB).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jpruning.upper_tri_device(jnp.asarray(m), RB, CB)))
    np.testing.assert_array_equal(
        got, m & tpruning.upper_mask(32, 16, RB, CB))


@pytest.mark.parametrize("strict", [False, True])
def test_le_planes_device(strict):
    rng = np.random.default_rng(23)
    d2b = rng.random((32, 16)).astype(np.float32)
    ts = [0.1, 0.5, np.float32(d2b[3, 4])]  # one threshold on a value
    got = tpruning.le_planes_device(torch.from_numpy(d2b), ts, strict)
    want = jpruning.le_planes_device(jnp.asarray(d2b),
                                     jnp.asarray(ts, dtype=jnp.float32),
                                     strict=strict)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tpruning.threshold_planes(torch.from_numpy(d2b), ts, strict),
        np.asarray(want))


@pytest.mark.parametrize("n_r", [1, 3])
def test_rmask_gather_device(n_r):
    nrb, ncb = 32, 16
    rng = np.random.default_rng(17 + n_r)
    planes = np.stack([rng.random((nrb, ncb)) < 0.5 for _ in range(n_r)])
    ti, tj = tpruning.tile_list(rng.random((nrb, ncb)) < 0.6)
    got = tpruning.rmask_gather_device(
        torch.from_numpy(planes), torch.from_numpy(ti), torch.from_numpy(tj))
    want = jpruning.rmask_gather_device(jnp.asarray(planes), jnp.asarray(ti),
                                        jnp.asarray(tj))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the numpy reference
    host = np.zeros(len(ti), np.int32)
    for r in range(n_r):
        host |= planes[r][ti, tj].astype(np.int32) << r
    np.testing.assert_array_equal(got.numpy(), host)


@pytest.mark.parametrize("p,seed", PS)
def test_tile_list_device(p, seed):
    m = _rand_mask(48, 24, p, 11 + seed)
    got = tpruning.tile_list_device(torch.from_numpy(m))
    host = tpruning.tile_list(m)
    n = int(m.sum())
    if n == 0:
        assert got is None and host is None
        assert jpruning.tile_list_device(jnp.asarray(m), 0) is None
        return
    ti, tj = got
    assert ti.dtype == tj.dtype == torch.int32
    assert ti.is_contiguous() and tj.is_contiguous()
    wi, wj = _dedupe(*jpruning.tile_list_device(jnp.asarray(m), n,
                                                max_entries=256))
    np.testing.assert_array_equal(ti.numpy(), wi)
    np.testing.assert_array_equal(tj.numpy(), wj)
    np.testing.assert_array_equal(ti.numpy(), host[0])
    np.testing.assert_array_equal(tj.numpy(), host[1])


@pytest.mark.parametrize("triangular", [True, False])
@pytest.mark.parametrize("row_lo,n_below", [(0, 300), (0, 512), (40, 300),
                                            (130, 512)])
def test_screen_active(row_lo, n_below, triangular):
    below = _rand_mask(64, 32, 0.4, 31)
    got = tscreening.screen_active(torch.from_numpy(below), n_below, row_lo,
                                   RB, CB, triangular)
    want = jscreening._screen_active_device(
        jnp.asarray(below), jnp.int32(n_below), jnp.int32(row_lo), RB, CB,
        triangular)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tscreening.screen_active(below, n_below, row_lo, RB, CB,
                                 triangular), np.asarray(want))


# -- the engines -----------------------------------------------------------------

@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(31)
    a = rng.normal((0.0, 0.0, 0.0), 0.15, size=(260, 3))
    b = rng.normal((1.5, 1.0, -0.5), 0.2, size=(240, 3))
    return np.concatenate([a, b]).astype(np.float32)


def _port_run(blobs, cb=CB, device="cpu"):
    eng = tengine.DensityEngine(blobs, RB, cb, device=device)
    pops = eng.populations([0.3, 0.45])
    nn = eng.nearest_neighbors(free_energies(pops[0.3]))
    return pops, nn, eng.last_stats


def _host_pops_plan(eng, name, radii, bidir=True):
    """The populations plan of the route by the numpy planners: (ti, tj,
    rmask) over the engine's bbox matrix of layout ``name``."""
    rb, cb = eng.row_block, eng.col_block
    sq = [np.float32(r) * np.float32(r) for r in radii]
    planes = tpruning.threshold_planes(eng.d2b(name), [max(sq)] + sq)
    active = planes[0]
    if bidir:
        active = active & tpruning.upper_mask(eng.n_pad // rb,
                                              eng.n_pad // cb, rb, cb)
    ti, tj = tpruning.tile_list(active)
    rmask = np.zeros(len(ti), np.int32)
    for r in range(len(radii)):
        rmask |= planes[1 + r][ti, tj].astype(np.int32) << r
    return ti, tj, rmask


def _assert_lists_equal(got, want):
    assert (got is None) == (want is None)
    for a, b in zip(got or (), want or ()):
        assert isinstance(a, torch.Tensor) and a.dtype == torch.int32
        np.testing.assert_array_equal(a.cpu().numpy(), b)


def _tiered_lists(eng, fe, bidir):
    """The tiered phase 2's device list of the route, from a band pass in
    Morton order over the dim0 layout's rows, and the numpy planners'
    list of the same active mask (closed upper-triangularly when
    ``bidir``)."""
    rb, cb = eng.row_block, eng.col_block
    order = tengine.NN_BAND_ORDER
    stats = {"band_tiles": 0, "t_plan": 0.0}
    keys = eng._nn_band(eng._fe_layout(fe, order), order,
                        tengine.NN_BAND_BLOCKS, bidir, stats)["keys"]
    rows = eng._nn_rows("dim0", eng._fe_layout(fe, "dim0"))
    qs = eng.TIER_QS_DEFAULT
    _, _, (tiles,) = eng._nn_tiered_plan(rows, keys, qs, bidir,
                                         dict(stats))
    tier, taus = tengine._ub_tiers(tkernels.unpack_keys(keys)[0],
                                   eng.n, qs)
    n_tiers = len(qs) + 1
    tier_w, perm = tengine._tier_sort_perm(tier, rows[0][2], eng.n, n_tiers)
    if bidir:
        rows_t, _, _, bound = tengine._tiered_rows(*rows[0], tier_w, taus,
                                                   perm, rb, n_tiers)
        active = tengine._tier_active(rows_t, bound, rb, cb).cpu().numpy()
        active = tpruning.bidir_closure(active, rb, cb)
    else:
        active = tengine._tiered_layout(*rows[0], tier_w, taus, perm, rb, cb,
                                        n_tiers)[3].cpu().numpy()
    return tiles, tpruning.tile_list(active)


def _assert_plans_match(eng, radii, series, md2, bidir=True, fe=None):
    """Every device planner of the route emits the numpy planners' list
    on the same masks: populations (with its rmask), the NN band (its
    closure when ``bidir``), the tiered phase 2 (from ``fe``, if given)
    and each series step's screening list (upper-triangular when
    ``bidir``)."""
    rb, cb = eng.row_block, eng.col_block
    name, *dev = eng.pops_plan(radii, bidir)
    _assert_lists_equal(dev, _host_pops_plan(eng, name, radii, bidir))
    band, swept = eng.nn_band_mask(bidir)
    nrb, ncb = band.shape
    host_band = tpruning.band_mask(nrb, ncb, rb, cb,
                                   tengine.NN_BAND_BLOCKS * cb)
    np.testing.assert_array_equal(band.cpu().numpy(), host_band)
    if bidir:
        host_band = tpruning.bidir_closure(host_band, rb, cb)
    _assert_lists_equal(tpruning.tile_list_device(swept),
                        tpruning.tile_list(host_band))
    if fe is not None:
        _assert_lists_equal(*_tiered_lists(eng, fe, bidir))
    seng, row_lo = series.engine, 0
    below = seng._below_plane(md2)
    for nb in series.n_below_per_band:
        for lo in {0, row_lo}:
            _assert_lists_equal(
                seng.tile_list(lo, int(nb), md2, triangular=bidir),
                tpruning.tile_list(tscreening.screen_active(
                    below.cpu().numpy(), int(nb), lo, seng.row_block,
                    seng.col_block, bidir)))
        row_lo = int(nb)


@pytest.mark.parametrize("cb", [CB, 64])
def test_engine_device_plan_equals_jax(blobs, monkeypatch, cb):
    """cb = 64 leaves 8 column blocks: no band pass, one full closure."""
    p_dev, nn_dev, st_dev = _port_run(blobs, cb)
    assert st_dev["populations"]["plan"] == st_dev["nn"]["plan"] == "device"
    assert (cb == CB) == (st_dev["nn"]["band_tiles"] > 0)
    assert 0.0 <= st_dev["populations"]["t_best_sort"] \
        <= st_dev["populations"]["t_plan"]
    # the JAX engine under its own device plan
    monkeypatch.setenv(JAX_DEVICE_PLAN, "1")
    je = jengine.DensityEngine(blobs, RB, cb, backend="pallas")
    j_pops = je.populations([0.3, 0.45])
    j_nn = je.nearest_neighbors(jdops.free_energies(j_pops[0.3]),
                                band_blocks=tengine.NN_BAND_BLOCKS,
                                tier_qs=None)
    assert je.last_stats["populations"]["plan"] == "device"
    for r in p_dev:
        np.testing.assert_array_equal(p_dev[r], j_pops[r])
    assert (st_dev["populations"]["computed_tiles"]
            == je.last_stats["populations"]["computed_tiles"])
    for i in (0, 2):
        np.testing.assert_array_equal(nn_dev[i], np.asarray(j_nn[i]))
    for i in (1, 3):
        _assert_ulp_close(nn_dev[i], j_nn[i])
    if cb == CB:
        assert je.last_stats["nn"]["plan"] == "device"
        for key in ("band_tiles", "phase2_tiles", "order"):
            assert st_dev["nn"][key] == je.last_stats["nn"][key]


def test_symmetric_routes_are_device_planned(blobs, monkeypatch):
    """The symmetric route plans on the device and gives the
    bidirectional route's results."""
    monkeypatch.setattr(tengine.DensityEngine, "POPS_BIDIR", False)
    monkeypatch.setattr(tengine.DensityEngine, "NN_BIDIR", False)
    p_sym, nn_sym, st = _port_run(blobs)
    assert st["populations"]["plan"] == st["nn"]["plan"] == "device"
    assert st["populations"]["mode"] == st["nn"]["route"] == "symmetric"
    monkeypatch.undo()
    p_dev, nn_dev, _ = _port_run(blobs)
    for r in p_dev:
        np.testing.assert_array_equal(p_dev[r], p_sym[r])
    for a, b in zip(nn_dev, nn_sym):
        np.testing.assert_array_equal(a, b)


def test_nn_times_are_disjoint(blobs):
    eng = tengine.DensityEngine(blobs, RB, CB, device="cpu")
    fe = free_energies(eng.populations([0.3])[0.3])
    t0 = time.perf_counter()
    eng.nearest_neighbors(fe)
    wall = time.perf_counter() - t0
    st = eng.last_stats["nn"]
    parts = [st["t_plan"], st["t_band"], st["t_sweep"]]
    assert min(parts) >= 0.0 and sum(parts) <= wall


def test_pops_plan_device_lists(blobs):
    eng = tengine.DensityEngine(blobs, RB, CB, device="cpu")
    radii = [0.2, 0.3, 0.45]
    stats = {}
    name, *dev = eng.pops_plan(radii, stats=stats)
    assert stats["t_best_sort"] >= 0.0
    for a in dev:
        assert isinstance(a, torch.Tensor) and a.dtype == torch.int32
    _assert_lists_equal(dev, _host_pops_plan(eng, name, radii))
    # the symmetric list, planned on the device too: the whole plane, its
    # upper part the bidirectional list
    name_s, *sym = eng.pops_plan(radii, bidir=False)
    assert name_s == name
    _assert_lists_equal(sym, _host_pops_plan(eng, name, radii, False))
    ti, tj, rmask = sym
    upper = ((tj + 1) * CB > ti * RB).numpy()
    _assert_lists_equal([ti[upper], tj[upper], rmask[upper]],
                        [a.numpy() for a in dev])
    assert not upper.all()


@pytest.mark.parametrize("bidir", [True, False], ids=["bidir", "symmetric"])
def test_plans_match_host_planners(blobs, bidir):
    eng = tengine.DensityEngine(blobs, RB, CB, device="cpu")
    pops = eng.populations([0.3])[0.3]
    fe = free_energies(pops)
    nn = eng.nearest_neighbors(fe)
    md2 = np.float32(4.0 * compute_sigma2(nn[1]))
    series = tscreening.ThresholdSeriesScreener(
        blobs, fe, [np.float32(t) for t in (0.5, 1.0, 2.0)], RB, CB,
        device="cpu")
    _assert_plans_match(eng, [0.3], series, md2, bidir, fe)


@pytest.mark.parametrize("stage", ["populations", "nn", "screening"])
def test_a_failing_device_planner_raises(blobs, monkeypatch, stage):
    """No fallback to the host plan when the device plan fails."""
    def boom(mask, rows=None):
        raise RuntimeError("out of memory")
    eng = tengine.DensityEngine(blobs, RB, CB, device="cpu")
    fe = free_energies(eng.populations([0.3])[0.3])
    monkeypatch.setattr(tpruning, "tile_list_device", boom)
    with pytest.raises(RuntimeError, match="out of memory"):
        if stage == "populations":
            eng.populations([0.3])
        elif stage == "nn":
            eng.nearest_neighbors(fe)
        else:
            tscreening.screening_labels(
                blobs, np.arange(len(blobs), dtype=np.int32), 400,
                np.float32(0.2), RB, CB, device="cpu")


# -- screening --------------------------------------------------------------------

@pytest.fixture(scope="module")
def series_blobs():
    rng = np.random.default_rng(41)
    a = rng.normal((0.0, 0.0, 0.0), 0.15, size=(300, 3))
    b = rng.normal((1.5, 1.0, -0.5), 0.2, size=(260, 3))
    c = rng.normal((-1.0, 1.2, 0.8), 0.25, size=(200, 3))
    return np.concatenate([a, b, c]).astype(np.float32)


@pytest.fixture(scope="module")
def series_fe(series_blobs):
    pops = jdops.populations(series_blobs, [0.4], backend="xla",
                             row_block=RB, col_block=CB)[0.4]
    return jdops.free_energies(pops)


THRESHOLDS = (0.5, 1.0, 1.5, 2.5)
MD2 = np.float32(0.08)


def _port_series(blobs, fe, hd):
    series = tscreening.ThresholdSeriesScreener(
        blobs, fe, [np.float32(t) for t in THRESHOLDS], RB, CB,
        device="cpu", hd_neighbors=hd)
    outs, stats, prev = [], [], None
    for k in range(len(THRESHOLDS)):
        prev = series.step(prev, k, MD2)
        outs.append(prev)
        stats.append(dict(series.engine.last_stats))
    return outs, stats


@pytest.mark.parametrize("seeded", [False, True])
def test_series_device_plan_equals_host_and_jax(series_blobs, series_fe,
                                                monkeypatch, seeded):
    """The bidirectional series against the symmetric one, both planned
    on the device, and the JAX series under its device plan."""
    hd = None
    if seeded:
        nn = jnops.nearest_neighbors(series_blobs, series_fe, backend="xla",
                                     row_block=RB, col_block=CB)
        hd = (np.asarray(nn[2]), np.asarray(nn[3]))
    got, st_dev = _port_series(series_blobs, series_fe, hd)
    monkeypatch.setattr(tscreening.ScreeningEngine, "BIDIR", False)
    want, st_sym = _port_series(series_blobs, series_fe, hd)
    for stats, mode in ((st_dev, "bidir"), (st_sym, "symmetric")):
        assert all(st["plan"] == "device" and st["mode"] == mode
                   for st in stats)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setenv(JAX_DEVICE_PLAN, "1")
    js = jscreening.ThresholdSeriesScreener(
        series_blobs, series_fe, [np.float32(t) for t in THRESHOLDS],
        row_block=RB, col_block=CB, backend="pallas", hd_neighbors=hd)
    prev = None
    for k, b in enumerate(got):
        prev = js.step(prev, k, MD2)
        np.testing.assert_array_equal(b, prev)
    assert all(st.get("plan") == "device" for st in js.per_step_stats)


def test_screening_run_device_plan(series_blobs, series_fe, monkeypatch,
                                   capsys):
    """Single-shot run: the bidirectional fixpoint and the symmetric one
    equal the JAX oracle, and the verbose line names the route that ran
    and the device plan."""
    order = np.argsort(series_fe, kind="stable")
    cs = series_blobs[order]
    labels0 = np.arange(len(cs), dtype=np.int32)
    want = jscreening.screening_labels(cs, labels0, 400, 0.2,
                                       row_block=RB, col_block=CB,
                                       backend="xla")
    lines = {}
    tlogger.set_verbose(True)
    try:
        for bidir in (True, False):
            monkeypatch.setattr(tscreening.ScreeningEngine, "BIDIR", bidir)
            eng = tscreening.ScreeningEngine(cs, RB, CB, device="cpu")
            capsys.readouterr()
            got = eng.run(labels0, 400, np.float32(0.2))
            lines[bidir] = capsys.readouterr().out
            np.testing.assert_array_equal(got, want)
    finally:
        tlogger.set_verbose(False)
    assert " bidir, device plan," in lines[True]
    assert " symmetric, device plan," in lines[False]
    assert "host plan" not in lines[True] + lines[False]


# -- on the card ------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")


def _card_run(coords, rb, cb):
    eng = tengine.DensityEngine(coords, rb, cb, device="cuda")
    pops = eng.populations([0.1])[0.1]
    fe = free_energies(pops)
    nn = eng.nearest_neighbors(fe)
    md2 = np.float32(4.0 * compute_sigma2(nn[1]))
    series = tscreening.ThresholdSeriesScreener(
        coords, fe, [np.float32(t) for t in (0.5, 1.0, 2.0)], rb, cb,
        device="cuda", hd_neighbors=(nn[2], nn[3]))
    clust, prev = [], None
    for k in range(3):
        prev = series.step(prev, k, md2)
        clust.append(prev)
    st = eng.last_stats
    plans = (st["populations"]["plan"], st["nn"]["plan"],
             series.engine.last_stats["plan"])
    return pops, nn, clust, plans, (eng, series, md2)


@pytest.mark.cuda
@pytest.mark.parametrize("rb,cb", [(128, 4096), (32, 256)])
def test_card_device_plan_equals_host_plan(monkeypatch, rb, cb):
    """2^16 frames on the card: every device planner's list equals the
    numpy planners' on the same masks, on both routes, and the
    bidirectional run gives the symmetric run's outputs, both planned on
    the device."""
    _need_cuda()
    rng = np.random.default_rng(7)
    centers = rng.normal(0.0, 1.0, size=(4, 4))
    coords = (centers[rng.integers(0, 4, size=1 << 16)]
              + rng.normal(0.0, 0.15, size=((1 << 16), 4))).astype(
                  np.float32)
    dev = _card_run(coords, rb, cb)
    assert dev[3] == ("device",) * 3
    eng, series, md2 = dev[4]
    fe = free_energies(dev[0])
    for bidir in (True, False):
        _assert_plans_match(eng, [0.1], series, md2, bidir, fe)
    for cls, switch in ((tengine.DensityEngine, "POPS_BIDIR"),
                        (tengine.DensityEngine, "NN_BIDIR"),
                        (tscreening.ScreeningEngine, "BIDIR")):
        monkeypatch.setattr(cls, switch, False)
    sym = _card_run(coords, rb, cb)
    assert sym[3] == ("device",) * 3
    np.testing.assert_array_equal(dev[0], sym[0])
    for a, b in zip(dev[1], sym[1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(dev[2], sym[2]):
        np.testing.assert_array_equal(a, b)
