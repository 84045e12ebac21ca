"""The port's populations finish and the host pieces of its largest runs.

``DensityEngine.populations`` ends as the JAX engine's ``_pops_finish``
does: one native pass (``textio_native.pops_finish``) scatter-unsorts the
padded (R, N_pad) int32 download to original frame positions and widens
it to int64; without the native library a numpy scatter and a cast per
radius give the same arrays. Here, at small N (not a multiple of the
blocks), on every route and with 1 and 3 radii: the two finishes
identical, each named in ``last_stats``; the port's finish equal to the
JAX engine's on the same download; the port's populations equal to the
JAX engine's (its Pallas kernels in interpret mode; counts are exact in
both distance classes here, as in ``tests/test_torch_density.py``). Also
the native ``%.6f`` row formatter that writes the CLI's 10^7-frame input
in ``chip_smoke.py`` (byte-equal to ``np.savetxt``) and the tier split
that NN's tiered phase 2 records.
"""

import io
import types

import numpy as np
import pytest

from clustering_tpu.ops import engine as jengine
from clustering_tpu_torch.ops import engine as tengine
from clustering_tpu_torch.utils import textio_native

RB, CB = 8, 16
N = 300  # 300 % lcm(8, 16) = 12: the pads run
RADII = {1: [0.3], 3: [0.15, 0.3, 0.45]}
ROUTES = ["bidir", "symmetric", "unpruned"]


def _coords(n=N, d=3, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.normal(0.0, 0.15, size=(n // 2, d))
    b = rng.normal(1.2, 0.2, size=(n - n // 2, d))
    return np.concatenate([a, b])[rng.permutation(n)].astype(np.float32)


def _port_pops(coords, radii, route, monkeypatch):
    monkeypatch.setattr(tengine.DensityEngine, "POPS_BIDIR",
                        route == "bidir")
    eng = tengine.DensityEngine(coords, RB, CB, device="cpu")
    got = eng.populations(radii, prune=route != "unpruned")
    return got, eng.last_stats["populations"]


@pytest.fixture(scope="module")
def jax_pops():
    """The JAX engine's populations of ``_coords()`` per radius count."""
    coords = _coords()
    return {k: jengine.DensityEngine(coords, RB, CB, backend="pallas")
            .populations(radii) for k, radii in RADII.items()}


@pytest.mark.parametrize("n_radii", sorted(RADII))
@pytest.mark.parametrize("route", ROUTES)
def test_native_and_numpy_finish_identical(route, n_radii, monkeypatch):
    assert textio_native.available()
    coords, radii = _coords(), RADII[n_radii]
    native, st = _port_pops(coords, radii, route, monkeypatch)
    assert st["finish"] == "native" and st["t_finish"] >= 0.0
    assert st["mode"] == ("bidir" if route == "bidir" else "symmetric")
    assert st["order"] in (("orig",) if route == "unpruned"
                           else ("dim0", "morton"))
    monkeypatch.setattr(tengine.textio_native, "pops_finish",
                        lambda *args: None)
    fallback, st = _port_pops(coords, radii, route, monkeypatch)
    assert st["finish"] == "numpy"
    assert list(native) == list(fallback) == radii
    for r in radii:
        assert native[r].dtype == fallback[r].dtype == np.int64
        assert native[r].shape == (N,)
        np.testing.assert_array_equal(native[r], fallback[r])


@pytest.mark.parametrize("finish", ["native", "numpy"])
@pytest.mark.parametrize("n_radii", sorted(RADII))
def test_finish_equals_jax_pops_finish(finish, n_radii, monkeypatch):
    """The port's ``_pops_finish`` and the JAX engine's on one padded
    download and frame order."""
    rng = np.random.default_rng(n_radii)
    n, n_pad, radii = 1000, 1024, RADII[n_radii]
    counts = rng.integers(1, 1 << 30, size=(len(radii), n_pad),
                          dtype=np.int32)
    order = rng.permutation(n)
    if finish == "numpy":
        for mod in (tengine, jengine):
            monkeypatch.setattr(mod.textio_native, "pops_finish",
                                lambda *args: None)
    fake = types.SimpleNamespace(n=n)
    got, how = tengine.DensityEngine._pops_finish(fake, counts, order,
                                                  radii)
    want = jengine.DensityEngine._pops_finish(fake, counts, order, radii)
    assert how == finish
    for r in radii:
        assert got[r].dtype == want[r].dtype == np.int64
        np.testing.assert_array_equal(got[r], want[r])
        np.testing.assert_array_equal(got[r][order],
                                      counts[radii.index(r), :n])


@pytest.mark.parametrize("n_radii", sorted(RADII))
@pytest.mark.parametrize("route", ROUTES)
def test_populations_equal_jax_engine(route, n_radii, jax_pops,
                                      monkeypatch):
    radii = RADII[n_radii]
    got, _ = _port_pops(_coords(), radii, route, monkeypatch)
    for r in radii:
        np.testing.assert_array_equal(got[r], jax_pops[n_radii][r])


@pytest.mark.parametrize("prec", [0, 3, 6])
def test_format_f_rows_equals_savetxt(prec):
    rng = np.random.default_rng(prec)
    rows = (rng.normal(size=(5000, 4)) * 3).astype(np.float32)
    # exact halves at 6 digits, signed zeros, tiny and large magnitudes
    rows[0] = [0.0078125, -0.0078125, -0.0, 1e-9]
    rows[1] = [-2.5e-7, 3.5e5, 9.9999995, -123456.78]
    want = io.BytesIO()
    np.savetxt(want, rows, fmt=f"%.{prec}f")
    assert bytes(textio_native.format_f_rows(rows, prec)) == want.getvalue()


def test_format_f_rows_refuses_what_outgrows_its_rows():
    with pytest.raises(ValueError):
        textio_native.format_f_rows(np.array([[1.0, 1e16]], np.float32))
    with pytest.raises(ValueError):
        textio_native.format_f_rows(np.ones((2, 2), np.float32), prec=18)


@pytest.mark.parametrize("route", ["bidir", "symmetric"])
def test_tiered_nn_records_the_tier_split(route, monkeypatch):
    monkeypatch.setattr(tengine.DensityEngine, "NN_BIDIR", route == "bidir")
    coords = _coords(n=600)
    eng = tengine.DensityEngine(coords, RB, CB, device="cpu")
    pops = eng.populations([0.3])[0.3]
    fe = -np.log(pops / pops.max()).astype(np.float32)
    qs = (0.5, 0.9, 0.99)
    eng.nearest_neighbors(fe, band_blocks=1, tier_qs=qs)
    st = eng.last_stats["nn"]
    assert st["mode"] == "tiered"
    assert len(st["tier_frames"]) == len(qs) + 1
    assert sum(st["tier_frames"]) == 600
    assert len(st["taus"]) == len(qs) and st["taus"] == sorted(st["taus"])
    eng.nearest_neighbors(fe, band_blocks=1, tier_qs=None)
    assert "tier_frames" not in eng.last_stats["nn"]
