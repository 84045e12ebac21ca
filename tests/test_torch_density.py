"""The port's density slice against the JAX package at small sizes.

The JAX side is ``DensityEngine(..., backend="pallas")`` and the Pallas
series screener at the same blocks (its kernels in interpret mode), not
``models.density.main``: the test session's 8 virtual CPU devices would
make that build a mesh. Populations, ids and cluster files must be exact.
Neighbour distances may differ by 1 ulp: the JAX engine recomputes them
with XLA's arithmetic (fma(d0, d0, d1*d1) then a chain), the port with
the plain fma chain of its kernels (ROADMAP.md, "Distance arithmetic").
"""

import os

import numpy as np
import pytest

import make_golden
from clustering_tpu import cli as jcli
from clustering_tpu.ops import density as jdops
from clustering_tpu.ops import engine as jengine
from clustering_tpu.ops import neighbors as jnops
from clustering_tpu.ops import screening as jscreening
from clustering_tpu_torch import api
from clustering_tpu_torch import cli as tcli
from clustering_tpu_torch.ops import density as tdops
from clustering_tpu_torch.ops import engine as tengine
from clustering_tpu_torch.ops import neighbors as tnops
from clustering_tpu_torch.ops import screening as tscreening

RB, CB = 8, 16


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


@pytest.mark.parametrize("d", [2, 3, 4])
def test_populations_match_jax_engine(d):
    coords = _blobs(300, d, seed=d)
    radii = [0.15, 0.3]
    want = jengine.DensityEngine(coords, RB, CB,
                                 backend="pallas").populations(radii)
    eng = tengine.DensityEngine(coords, RB, CB, device="cpu")
    got = eng.populations(radii)
    dense = tdops.populations_dense(coords, radii)
    for r in radii:
        np.testing.assert_array_equal(got[r], want[r])
        np.testing.assert_array_equal(dense[r], want[r])


@pytest.mark.parametrize("d,dup", [(2, 0), (3, 6), (4, 0)])
def test_nearest_neighbors_match_jax_engine(d, dup):
    coords = _blobs(360, d, seed=10 + d, dup=dup)
    pops = jdops.populations(coords, [0.3], backend="xla",
                             row_block=RB, col_block=CB)[0.3]
    fe = jdops.free_energies(pops)
    want = jengine.DensityEngine(coords, RB, CB,
                                 backend="pallas").nearest_neighbors(fe)
    eng = tengine.DensityEngine(coords, RB, CB, device="cpu")
    got = eng.nearest_neighbors(fe)
    assert eng.last_stats["nn"]["band_tiles"] > 0  # the band pass ran
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    _assert_ulp_close(got[1], want[1])
    _assert_ulp_close(got[3], want[3])
    dense = tnops.nearest_neighbors_dense(coords, fe)
    xla = jnops.nearest_neighbors(coords, fe, backend="xla",
                                  row_block=RB, col_block=CB)
    for i in (0, 2):
        np.testing.assert_array_equal(dense[i], got[i])
        np.testing.assert_array_equal(xla[i], got[i])
    for i in (1, 3):
        np.testing.assert_array_equal(dense[i], got[i])
    # the lowest-fe frame has no lower-fe neighbour: (0, 0.0)
    lo = int(np.argmin(fe))
    assert got[2][lo] == 0 and got[3][lo] == 0.0


def test_nearest_neighbors_all_duplicates():
    same = np.zeros((40, 2), np.float32)
    eng = tengine.DensityEngine(same, RB, CB, device="cpu")
    got = eng.nearest_neighbors(np.zeros(40, np.float32))
    # 3 column blocks: too few for the band pass, one full sweep instead
    assert eng.last_stats["nn"]["band_tiles"] == 0
    for arr in got:
        assert not np.asarray(arr).any()


def _fe_nn(coords):
    pops = jdops.populations(coords, [0.3], backend="xla",
                             row_block=RB, col_block=CB)[0.3]
    fe = jdops.free_energies(pops)
    nn = jnops.nearest_neighbors(coords, fe, backend="xla",
                                 row_block=RB, col_block=CB)
    return fe, nn


@pytest.mark.parametrize("seeded", [False, True])
def test_series_screener_matches_jax(seeded):
    coords = _blobs(500, 3, seed=21)
    fe, nn = _fe_nn(coords)
    thresholds = [np.float32(t) for t in
                  np.quantile(fe, [0.1, 0.35, 0.7, 1.0])]
    md2 = np.float32(4.0 * jnops.compute_sigma2(nn[1]))
    hd = (nn[2], nn[3]) if seeded else None
    js = jscreening.ThresholdSeriesScreener(coords, fe, thresholds, RB, CB,
                                            backend="pallas",
                                            hd_neighbors=hd)
    ts = tscreening.ThresholdSeriesScreener(coords, fe, thresholds, RB, CB,
                                            device="cpu", hd_neighbors=hd)
    a = b = None
    for k in range(len(thresholds)):
        a = js.step(a, k, md2)
        b = ts.step(b, k, md2)
        np.testing.assert_array_equal(b, a)
        assert ts.engine.last_stats["sweeps"] >= 1
    # the generic (arbitrary previous clustering) seed path
    ts.reset()
    c = None
    for k in range(len(thresholds)):
        c = ts.step(None if c is None else c.copy(), k, md2)
    np.testing.assert_array_equal(c, a)


def test_step_submit_matches_step():
    from concurrent.futures import ThreadPoolExecutor
    coords = _blobs(400, 2, seed=31)
    fe, nn = _fe_nn(coords)
    thresholds = [np.float32(t) for t in (0.2, 0.5, 0.6, 1.0, 3.0)]
    md2 = np.float32(4.0 * jnops.compute_sigma2(nn[1]))
    s1 = tscreening.ThresholdSeriesScreener(coords, fe, thresholds, RB, CB,
                                            device="cpu",
                                            hd_neighbors=(nn[2], nn[3]))
    s2 = tscreening.ThresholdSeriesScreener(coords, fe, thresholds, RB, CB,
                                            device="cpu",
                                            hd_neighbors=(nn[2], nn[3]))
    prev = None
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = [s2.step_submit(k, md2, pool) for k in range(len(thresholds))]
        for k, f in enumerate(futs):
            prev = s1.step(prev, k, md2)
            np.testing.assert_array_equal(f.result(), prev)


def test_screening_engine_matches_jax():
    coords = _blobs(300, 2, seed=41)
    fe, _ = _fe_nn(coords)
    cs = coords[np.argsort(fe, kind="stable")]
    labels0 = np.arange(len(cs), dtype=np.int32)
    for nb, md2 in ((150, 0.01), (300, 0.05)):
        want = jscreening.screening_labels(cs, labels0, nb, md2,
                                           backend="pallas",
                                           row_block=RB, col_block=CB)
        got = tscreening.ScreeningEngine(cs, RB, CB, device="cpu").run(
            labels0, nb, md2)
        np.testing.assert_array_equal(got, want)


def test_api_matches_engines():
    coords = _blobs(300, 2, seed=51)
    pops = api.populations(coords, 0.3, device="cpu")
    np.testing.assert_array_equal(
        pops, jdops.populations(coords, [0.3], backend="xla")[0.3])
    multi = api.populations(coords, [0.2, 0.3], device="cpu")
    np.testing.assert_array_equal(multi[0.3], pops)
    fe = api.free_energies(pops)
    nn = api.nearest_neighbors(coords, fe, device="cpu")
    np.testing.assert_array_equal(
        nn.nhhd_idx, jnops.nearest_neighbors(coords, fe, backend="xla")[2])
    thresholds = [0.5, 1.0, 2.0]
    got = api.screening_series(coords, fe, nn.nh_dist, thresholds,
                               device="cpu",
                               hd_neighbors=(nn.nhhd_idx, nn.nhhd_dist))
    md2 = np.float32(4.0 * jnops.compute_sigma2(nn.nh_dist))
    ref = jscreening.ThresholdSeriesScreener(coords, fe, thresholds,
                                             backend="pallas")
    prev = None
    for k, g in enumerate(got):
        prev = ref.step(prev, k, md2)
        np.testing.assert_array_equal(g, prev)


def _nn_rows(path):
    rows = [ln.split() for ln in make_golden.strip_volatile(path)
            .splitlines() if not ln.startswith("#")]
    return np.asarray(rows, dtype=np.float64)


def test_golden_chain_through_port_cli(tmp_path, monkeypatch):
    """make_golden's whole argv chain through the port's CLI on the CPU:
    every file byte-equal to tests/golden/ except the nn distance columns,
    which may differ in the last of their 6 printed digits (the goldens
    hold the XLA route's distances, 1 ulp from the fma chain)."""
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    monkeypatch.setattr(jcli, "main", tcli.main)
    make_golden.generate(str(tmp_path))
    for name in make_golden.FILES:
        got = make_golden.strip_volatile(str(tmp_path / name))
        want = open(os.path.join(make_golden.GOLDEN, name)).read()
        if name != "nn":
            assert got == want, name
    g = _nn_rows(str(tmp_path / "nn"))
    w = _nn_rows(os.path.join(make_golden.GOLDEN, "nn"))
    np.testing.assert_array_equal(g[:, [0, 2]], w[:, [0, 2]])
    unit = 10.0 ** (np.floor(np.log10(np.maximum(w[:, [1, 3]], 1e-30))) - 5)
    assert (np.abs(g[:, [1, 3]] - w[:, [1, 3]]) <= unit * 1.0000001).all()


def test_cli_multi_radius_and_lumping_radius(tmp_path, monkeypatch):
    coords = _blobs(300, 2, seed=61)
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    monkeypatch.chdir(tmp_path)
    np.savetxt("c.dat", coords, fmt="%.6f")
    c = np.loadtxt("c.dat").astype(np.float32)
    assert tcli.main(["density", "-f", "c.dat", "-R", "0.1", "0.2",
                      "-p", "pop", "-d", "fe"]) == 0
    want = jdops.populations(c, [0.1, 0.2], backend="pallas",
                             row_block=RB, col_block=CB)
    for r in (0.1, 0.2):
        got = np.loadtxt("pop_%f" % r, dtype=np.int64)
        np.testing.assert_array_equal(got, want[r])
        fe = np.loadtxt("fe_%f" % r)
        np.testing.assert_allclose(fe, jdops.free_energies(want[r]),
                                   rtol=1e-5)
    # no -r: populations at 1.0 and NN statistics give the lumping radius
    assert tcli.main(["density", "-f", "c.dat", "-p", "pl", "-b", "nl"]) == 0
    fe1 = jdops.free_energies(
        jdops.populations(c, [1.0], backend="xla")[1.0])
    nh_d = jnops.nearest_neighbors(c, fe1, backend="xla")[1]
    lump = float(np.sqrt(np.float32(4.0 * jnops.compute_sigma2(nh_d))))
    head = open("pl").read()
    assert "#@   lumping_radius = %.5f" % lump in head
    assert "#@   clustering_radius = %.5f" % lump in head


@pytest.mark.parametrize("case", ["files", "nn_dies"])
def test_cli_scan_of_one_radius(tmp_path, monkeypatch, capsys, case):
    """``-R r`` with one radius takes the populations path of ``-r r``:
    its pop_%f and fe_%f files hold the values of the ``-r`` files; with
    ``-b`` it starts no band prefetch, and the NN stage dies with the
    reference's message."""
    coords = _blobs(300, 2, seed=63)
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    monkeypatch.chdir(tmp_path)
    np.savetxt("c.dat", coords, fmt="%.6f")
    if case == "files":
        for flag in ("-r", "-R"):
            assert tcli.main(["density", "-f", "c.dat", flag, "0.2", "-p",
                              "pop", "-d", "fe"]) == 0
        for name in ("pop", "fe"):
            np.testing.assert_array_equal(np.loadtxt(f"{name}_{0.2:f}"),
                                          np.loadtxt(name))
        return
    bands = []
    populations = tengine.DensityEngine.populations

    def logged(self, radii, *args, **kw):
        bands.append(kw.get("nn_band_radius"))
        return populations(self, radii, *args, **kw)

    monkeypatch.setattr(tengine.DensityEngine, "populations", logged)
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        tcli.main(["density", "-f", "c.dat", "-R", "0.2", "-p", "pop",
                   "-b", "nn"])
    assert exc.value.code == 1 and bands == [None]
    assert capsys.readouterr().err == (
        "error: nearest neighbor calculation cannot be done with\n"
        "       several radii (-R is set).\n")
    assert os.path.exists(f"pop_{0.2:f}") and not os.path.exists("nn")


def _data_lines(path):
    """The file's lines without the plain '#' header (argv, time stamp)."""
    with open(path) as fh:
        return [ln for ln in fh if ln.startswith("#@")
                or not ln.startswith("#")]


def test_cli_check_mode(tmp_path, monkeypatch, capsys):
    """--check recomputes populations and neighbours with the dense plain
    versions, logs how many entries differ, and leaves the files as they
    are without it."""
    coords = _blobs(300, 2, seed=71)
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    monkeypatch.chdir(tmp_path)
    np.savetxt("c.dat", coords, fmt="%.6f")
    outs = {}
    for tag, extra in (("plain", []), ("check", ["--check"])):
        argv = ["density", "-f", "c.dat", "-r", "0.2", "-p", f"pop_{tag}",
                "-d", f"fe_{tag}", "-b", f"nn_{tag}", "-v"] + extra
        assert tcli.main(argv) == 0
        outs[tag] = capsys.readouterr().out
    for name in ("pop", "fe", "nn"):
        assert _data_lines(f"{name}_check") == _data_lines(f"{name}_plain")
    assert "[check]" not in outs["plain"]
    for kind, total in (("pops", 300), ("nn", 600)):
        lines = [ln for ln in outs["check"].splitlines()
                 if f"[check] {kind}:" in ln]
        assert len(lines) == 1, outs["check"]
        bad, n = lines[0].split(":")[1].split()[0].split("/")
        assert int(n) == total and int(bad) <= 0.01 * total
