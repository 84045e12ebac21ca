"""The port's NN band prefetch (populations -> nearest_neighbors overlap)
and the CLI's screener built during the NN stage.

Mirrors ``tests/test_band_prefetch.py``: ``populations(...,
nn_band_radius=r)`` starts the band pass from that radius's counts;
``nearest_neighbors`` takes it only when its free energies equal the
stash's bit for bit and its band, order and route match, else drops it.
Results are bit-identical to a run without the prefetch in every case,
and a failure inside the prefetch reaches the caller.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import make_golden
from clustering_tpu import cli as jcli
from clustering_tpu import ops as jops
from clustering_tpu.ops import engine as jengine
from clustering_tpu_torch import cli as tcli
from clustering_tpu_torch.models import density as tdensity
from clustering_tpu_torch.ops import engine as tengine
from clustering_tpu_torch.ops.density import free_energies

RB, CB = 8, 16
R = 0.4


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(5)
    a = rng.normal((0.0, 0.0, 0.0), 0.15, size=(160, 3))
    b = rng.normal((1.5, 1.0, -0.5), 0.2, size=(140, 3))
    return np.concatenate([a, b]).astype(np.float32)


def _engine(blobs, route="bidir"):
    eng = tengine.DensityEngine(blobs, RB, CB, device="cpu")
    eng.NN_BIDIR = route == "bidir"
    return eng


def _assert_bit_equal(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        bits = np.int32 if b.dtype.kind == "f" else b.dtype
        np.testing.assert_array_equal(a.view(bits), b.view(bits))


@pytest.mark.parametrize("tier_qs", [None, (0.5, 0.9, 0.99)])
@pytest.mark.parametrize("route", ["bidir", "symmetric"])
def test_prefetch_hit_bit_equal(blobs, route, tier_qs):
    eng_pf, eng_plain = _engine(blobs, route), _engine(blobs, route)
    pops = eng_pf.populations([R], nn_band_radius=R)[R]
    assert eng_pf.last_stats["populations"]["nn_band_prefetch"]
    np.testing.assert_array_equal(pops, eng_plain.populations([R])[R])
    assert "nn_band_prefetch" not in eng_plain.last_stats["populations"]
    fe = free_energies(pops)
    got = eng_pf.nearest_neighbors(fe, tier_qs=tier_qs)
    st = eng_pf.last_stats["nn"]
    assert st["band_prefetched"] is True and st["band_tiles"] > 0
    want = eng_plain.nearest_neighbors(fe, tier_qs=tier_qs)
    assert eng_plain.last_stats["nn"]["band_prefetched"] is False
    for key in ("band_tiles", "phase2_tiles", "order", "mode"):
        assert st[key] == eng_plain.last_stats["nn"][key], key
    _assert_bit_equal(got, want)
    # and the JAX engine's own prefetched run finds the same neighbours
    je = jengine.DensityEngine(blobs, row_block=RB, col_block=CB,
                               backend="pallas")
    if route == "symmetric":
        je.NN_BIDIR_SCRATCH_CAP = 0
    j_fe = jops.free_energies(je.populations([R], nn_band_radius=R)[R])
    np.testing.assert_array_equal(j_fe, fe)
    j_nn = je.nearest_neighbors(j_fe, tier_qs=tier_qs)
    assert je.last_stats["nn"].get("band_prefetched") is True
    for i in (0, 2):
        np.testing.assert_array_equal(got[i], np.asarray(j_nn[i]))


def test_prefetch_consumed_once(blobs):
    eng = _engine(blobs)
    fe = free_energies(eng.populations([R], nn_band_radius=R)[R])
    first = eng.nearest_neighbors(fe)
    assert eng.last_stats["nn"]["band_prefetched"] is True
    second = eng.nearest_neighbors(fe)
    assert eng.last_stats["nn"]["band_prefetched"] is False
    _assert_bit_equal(second, first)


# what the consumer changes: its fe, its band, its band order, its route
MISMATCH = {
    "fe": lambda eng, fe: eng.nearest_neighbors(fe * np.float32(1.5)),
    "fe one ulp": lambda eng, fe: eng.nearest_neighbors(
        np.where(np.arange(len(fe)) == 3, np.nextafter(fe, np.inf), fe)
        .astype(np.float32)),
    "band_blocks": lambda eng, fe: eng.nearest_neighbors(fe, band_blocks=2),
    "order_name": lambda eng, fe: eng.nearest_neighbors(fe,
                                                        order_name="dim0"),
    "route": lambda eng, fe: (setattr(eng, "NN_BIDIR", False),
                              eng.nearest_neighbors(fe))[1],
}


@pytest.mark.parametrize("what", list(MISMATCH))
def test_prefetch_mismatch_drops_the_stash(blobs, what):
    eng_pf, eng_plain = _engine(blobs), _engine(blobs)
    fe = free_energies(eng_pf.populations([R], nn_band_radius=R)[R])
    eng_plain.populations([R])
    got = MISMATCH[what](eng_pf, fe)
    assert eng_pf.last_stats["nn"]["band_prefetched"] is False
    assert eng_pf._band_prefetch is None  # dropped, not kept stale
    _assert_bit_equal(got, MISMATCH[what](eng_plain, fe))


def test_prefetch_radius_not_in_the_list(blobs):
    eng = _engine(blobs)
    eng.populations([R], nn_band_radius=0.7)
    assert "nn_band_prefetch" not in eng.last_stats["populations"]
    assert eng._band_prefetch_thread is None


def test_prefetch_failure_reaches_the_caller(blobs, monkeypatch):
    eng_pf, eng_plain = _engine(blobs), _engine(blobs)
    band = tengine.DensityEngine._nn_band

    def broken(self, *args):
        raise RuntimeError("band pass failed")

    monkeypatch.setattr(tengine.DensityEngine, "_nn_band", broken)
    pops = eng_pf.populations([R], nn_band_radius=R)[R]
    fe = free_energies(pops)
    with pytest.raises(RuntimeError, match="band pass failed"):
        eng_pf.nearest_neighbors(fe)
    # raised once; the engine then runs on without the stash
    monkeypatch.setattr(tengine.DensityEngine, "_nn_band", band)
    got = eng_pf.nearest_neighbors(fe)
    assert eng_pf.last_stats["nn"]["band_prefetched"] is False
    eng_plain.populations([R])
    _assert_bit_equal(got, eng_plain.nearest_neighbors(fe))


def test_cli_prefetches_and_builds_the_screener_during_nn(
        tmp_path, monkeypatch, capsys):
    """make_golden's chain through the port's CLI on the CPU, its engine
    on blocks (8, 16) so that the band pass runs (default blocks leave too
    few column blocks at 350 frames): the populations stage starts the
    band pass, NN takes it, the screener is built on the write pool while
    NN runs, and every file equals tests/golden/ (nn distances to the
    last printed digit, as in test_torch_density)."""
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    monkeypatch.setattr(tdensity, "DensityEngine", functools.partial(
        tengine.DensityEngine, row_block=RB, col_block=CB))
    events = []
    nn = tengine.DensityEngine.nearest_neighbors

    class Pool(ThreadPoolExecutor):
        def submit(self, fn, *args, **kw):
            if fn is tdensity._build_screener:
                events.append("screener submitted")
            return super().submit(fn, *args, **kw)

    def nn_logged(self, *args, **kw):
        events.append("nn start")
        out = nn(self, *args, **kw)
        events.append("nn end")
        return out

    monkeypatch.setattr(tdensity, "ThreadPoolExecutor", Pool)
    monkeypatch.setattr(tengine.DensityEngine, "nearest_neighbors",
                        nn_logged)
    monkeypatch.setattr(jcli, "main", lambda argv: tcli.main(
        argv + ["-v"] if "-T" in argv else argv))
    make_golden.generate(str(tmp_path))
    out = capsys.readouterr().out
    assert events == ["screener submitted", "nn start", "nn end"]
    assert ", band prefetched]" in out
    assert "[screener built during nearest neighbors in" in out
    for name in make_golden.FILES:
        got = make_golden.strip_volatile(str(tmp_path / name))
        want = open(os.path.join(make_golden.GOLDEN, name)).read()
        if name != "nn":
            assert got == want, name
    rows = []
    for path in (tmp_path / "nn", os.path.join(make_golden.GOLDEN, "nn")):
        rows.append(np.asarray(
            [ln.split() for ln in make_golden.strip_volatile(str(path))
             .splitlines() if not ln.startswith("#")], dtype=np.float64))
    g, w = rows
    np.testing.assert_array_equal(g[:, [0, 2]], w[:, [0, 2]])
    unit = 10.0 ** (np.floor(np.log10(np.maximum(w[:, [1, 3]], 1e-30))) - 5)
    assert (np.abs(g[:, [1, 3]] - w[:, [1, 3]]) <= unit * 1.0000001).all()


# -- band_sigma2_estimate ------------------------------------------------------

@pytest.mark.parametrize("route", ["bidir", "symmetric"])
def test_band_sigma2_estimate_matches_jax_and_keeps_the_stash(blobs, route):
    eng = _engine(blobs, route)
    pops = eng.populations([R], nn_band_radius=R)[R]
    est = eng.band_sigma2_estimate()
    je = jengine.DensityEngine(blobs, row_block=RB, col_block=CB,
                               backend="pallas")
    if route == "symmetric":
        je.NN_BIDIR_SCRATCH_CAP = 0
    je.populations([R], nn_band_radius=R)
    want = je.band_sigma2_estimate()
    assert want is not None and est is not None
    np.testing.assert_allclose(est, want, rtol=1e-5)
    # the stash stays for NN, and is gone once NN took it
    eng.nearest_neighbors(free_energies(pops))
    assert eng.last_stats["nn"]["band_prefetched"] is True
    assert eng.band_sigma2_estimate() is None


def test_band_sigma2_estimate_without_a_stash(blobs):
    eng = _engine(blobs)
    assert eng.band_sigma2_estimate() is None
    eng.populations([R])
    assert eng.band_sigma2_estimate() is None


# -- the warms -----------------------------------------------------------------

def test_precompile_returns_at_once_on_the_cpu(blobs, monkeypatch):
    """On the CPU the warms do nothing: no scratch engine, no sweep."""
    from clustering_tpu_torch.ops import screening

    def refused(*args, **kw):
        raise AssertionError("a warm ran on the CPU")

    series = screening.ThresholdSeriesScreener(blobs, np.zeros(len(blobs)),
                                               [0.5], RB, CB, device="cpu")
    monkeypatch.setattr(tengine.DensityEngine, "_scratch", refused)
    monkeypatch.setattr(screening.ScreeningEngine, "__init__", refused)
    monkeypatch.setattr(tengine, "warm_failed", refused)
    monkeypatch.setattr(screening, "warm_failed", refused)
    eng = _engine(blobs)
    assert eng.precompile_pops([R]) is None
    assert eng.precompile_nn() is None
    assert series.precompile(np.float32(0.1)) is None
    assert series.precompile(np.float32(0.1), compile_only=True) is None


def test_warm_bodies_leave_the_results_unchanged(blobs, monkeypatch):
    """The warms' own logic, run on the CPU (``warm_on`` forced): each runs
    its stage on a scratch engine, touches none of the engine's caches,
    and the stages that follow give results bit-equal to a fresh
    engine's."""
    from clustering_tpu_torch.ops import screening

    def failed(what, exc):
        raise AssertionError(f"{what}: {exc!r}")

    scratches = []
    scratch = tengine.DensityEngine._scratch

    def recorded(self, *args):
        scratches.append(scratch(self, *args))
        return scratches[-1]

    for mod in (tengine, screening):
        monkeypatch.setattr(mod, "warm_on", lambda device, mesh: True)
        monkeypatch.setattr(mod, "warm_failed", failed)
    monkeypatch.setattr(tengine.DensityEngine, "_scratch", recorded)
    eng, fresh = _engine(blobs), _engine(blobs)
    eng.precompile_pops([R])
    eng.precompile_nn()
    assert eng._dev == {} and eng._orders == {} and eng.last_stats == {}
    assert eng._band_prefetch is None and eng._band_prefetch_thread is None
    # the scratch engines ran the stages: populations with its band
    # prefetch, NN on a tiered phase 2
    assert [s.n for s in scratches] == [9 * CB, 9 * CB]
    assert scratches[0].last_stats["populations"]["nn_band_prefetch"]
    assert scratches[1].last_stats["nn"]["mode"] == "tiered"
    pops = eng.populations([R], nn_band_radius=R)[R]
    fe = free_energies(pops)
    est = eng.band_sigma2_estimate()
    series = screening.ThresholdSeriesScreener(blobs, fe, [0.6, 1.2], RB, CB,
                                               device="cpu")
    series.precompile(np.float32(4.0 * est), compile_only=True)
    got = eng.nearest_neighbors(fe)
    assert eng.last_stats["nn"]["band_prefetched"] is True
    fe_fresh = free_energies(fresh.populations([R])[R])
    np.testing.assert_array_equal(pops, fresh.populations([R])[R])
    _assert_bit_equal(got, fresh.nearest_neighbors(fe_fresh))
    md2 = np.float32(4.0 * np.mean(got[1], dtype=np.float64))
    series.precompile(md2)
    assert series._labels is None and series.engine._below is None
    want = screening.ThresholdSeriesScreener(blobs, fe, [0.6, 1.2], RB, CB,
                                             device="cpu")
    a = b = None
    for k in range(2):
        a, b = series.step(a, k, md2), want.step(b, k, md2)
        np.testing.assert_array_equal(a, b)


def test_cli_starts_no_warm_thread_on_the_cpu(tmp_path, monkeypatch):
    """The density CLI on the CPU: no precompile or device-warm thread."""
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    monkeypatch.chdir(tmp_path)
    from clustering_tpu_torch.ops import screening
    started = []
    for cls, name in ((tengine.DensityEngine, "precompile_pops"),
                      (tengine.DensityEngine, "precompile_nn"),
                      (screening.ThresholdSeriesScreener, "precompile")):
        monkeypatch.setattr(cls, name, lambda *a, _n=name, **k:
                            started.append(_n))
    monkeypatch.setattr(tcli, "_start_device_warm",
                        lambda device: started.append(device))
    rng = np.random.default_rng(3)
    np.savetxt("coords.dat", rng.normal(size=(200, 2)), fmt="%.5f")
    assert tcli.main(["density", "-f", "coords.dat", "-r", "0.3", "-o", "c",
                      "-T", "0.5", "0.5", "1.5", "-b", "nn"]) == 0
    assert started == []
    eng = tengine.DensityEngine(np.zeros((4, 2), np.float32), device="cpu")
    assert not tdensity._precompile_on(eng)
    # the warms' gate: a CUDA device without a mesh, nothing else
    cuda = torch.device("cuda")
    assert tengine.warm_on(cuda, None)
    assert not tengine.warm_on(cuda, object())
    assert not tengine.warm_on(torch.device("cpu"), None)
