"""Every call form of the JAX package's ops entry points and engines, made
on the port with the JAX package's parameter order, and the CLI's
whole-run profile trace.

The JAX package's ``populations``, ``nearest_neighbors``,
``screening_labels``, ``DensityEngine``, ``ScreeningEngine`` and
``ThresholdSeriesScreener`` take ``backend`` (and the first two
``prune``) before the port's own ``device`` and ``mesh``. Each call form
below, positional and keyword, runs the port on the CPU and is held
against the JAX package on the same inputs: the Pallas route in
interpret mode for "auto" and "pallas" (counts, ids and labels exact),
the XLA route for "xla" (counts and ids exact, distances within 1 ulp:
the XLA route's distance arithmetic, ROADMAP.md C.5).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from clustering_tpu.ops import density as jdops
from clustering_tpu.ops import engine as jengine
from clustering_tpu.ops import neighbors as jnops
from clustering_tpu.ops import screening as jscreening
from clustering_tpu_torch.ops import density as tdops
from clustering_tpu_torch.ops import engine as tengine
from clustering_tpu_torch.ops import neighbors as tnops
from clustering_tpu_torch.ops import screening as tscreening

ROOT = pathlib.Path(__file__).resolve().parent.parent
RB, CB = 8, 16
RADII = [0.3, 0.6]
THRESHOLDS = [0.5, 1.0, 2.0]


@pytest.fixture(scope="module")
def data():
    """Inputs and the JAX package's results on them."""
    rng = np.random.default_rng(31)
    coords = np.concatenate([
        rng.normal((0.0, 0.0, 0.0), 0.2, size=(150, 3)),
        rng.normal((1.2, 0.8, -0.4), 0.25, size=(110, 3)),
    ]).astype(np.float32)
    pops = jdops.populations(coords, RADII, RB, CB, "pallas")
    fe = jdops.free_energies(pops[0.6])
    nn = jnops.nearest_neighbors(coords, fe, RB, CB, "pallas")
    md2 = np.float32(4.0 * jnops.compute_sigma2(nn[1]))
    order = np.argsort(fe, kind="stable")
    n_below = int((fe <= np.float32(1.0)).sum())
    labels0 = np.arange(len(fe), dtype=np.int32)
    return dict(
        coords=coords, fe=fe, md2=md2, cs=coords[order], n_below=n_below,
        labels0=labels0,
        pops={"pallas": pops, "unpruned": jdops.populations(
            coords, RADII, RB, CB, "pallas", False),
            "xla": jdops.populations(coords, RADII, RB, CB, "xla")},
        nn={"pallas": nn, "xla": jnops.nearest_neighbors(coords, fe, RB, CB,
                                                         "xla")},
        labels=jscreening.screening_labels(coords[order], labels0, n_below,
                                           md2, RB, CB, "pallas"))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _same_pops(got, want):
    assert sorted(got) == sorted(want)
    for r in want:
        assert got[r].dtype == np.int64
        np.testing.assert_array_equal(got[r], np.asarray(want[r]))


def _same_nn(got, data):
    want = data["nn"]["pallas"]
    for i in (0, 2):
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
    for i in (1, 3):
        assert _ulps(got[i], data["nn"]["xla"][i]) <= 1


# -- ops.density.populations ---------------------------------------------------

POPS_FORMS = {
    "positional auto": (lambda d: tdops.populations(
        d["coords"], RADII, RB, CB, "auto", True, "cpu"), "pallas"),
    "positional pallas, mesh": (lambda d: tdops.populations(
        d["coords"], RADII, RB, CB, "pallas", True, "cpu", None), "pallas"),
    "keywords": (lambda d: tdops.populations(
        d["coords"], RADII, row_block=RB, col_block=CB, backend="pallas",
        prune=True, device="cpu", mesh=None), "pallas"),
    "positional unpruned": (lambda d: tdops.populations(
        d["coords"], RADII, RB, CB, "pallas", False, "cpu"), "unpruned"),
    "keyword unpruned": (lambda d: tdops.populations(
        d["coords"], RADII, row_block=RB, col_block=CB, prune=False,
        device="cpu"), "unpruned"),
    "positional xla": (lambda d: tdops.populations(
        d["coords"], RADII, RB, CB, "xla", True, "cpu"), "xla"),
    "keyword xla": (lambda d: tdops.populations(
        d["coords"], RADII, backend="xla", device="cpu"), "xla"),
}


@pytest.mark.parametrize("form", list(POPS_FORMS))
def test_populations_call_forms(data, form):
    call, want = POPS_FORMS[form]
    got = call(data)
    _same_pops(got, data["pops"][want])
    # every route gives the same counts
    _same_pops(got, data["pops"]["pallas"])


def test_populations_xla_is_the_dense_plain_version(data):
    got = tdops.populations(data["coords"], RADII, RB, CB, "xla",
                            device="cpu")
    _same_pops(got, tdops.populations_dense(data["coords"], RADII))


# -- ops.neighbors.nearest_neighbors -------------------------------------------

NN_FORMS = {
    "positional auto": lambda d: tnops.nearest_neighbors(
        d["coords"], d["fe"], RB, CB, "auto", True, "cpu"),
    "positional pallas, mesh": lambda d: tnops.nearest_neighbors(
        d["coords"], d["fe"], RB, CB, "pallas", True, "cpu", None),
    "keywords": lambda d: tnops.nearest_neighbors(
        d["coords"], d["fe"], row_block=RB, col_block=CB, backend="pallas",
        prune=True, device="cpu", mesh=None),
    "positional unpruned": lambda d: tnops.nearest_neighbors(
        d["coords"], d["fe"], RB, CB, "pallas", False, "cpu"),
    "positional xla": lambda d: tnops.nearest_neighbors(
        d["coords"], d["fe"], RB, CB, "xla", True, "cpu"),
    "keyword xla": lambda d: tnops.nearest_neighbors(
        d["coords"], d["fe"], backend="xla", device="cpu"),
}


@pytest.mark.parametrize("form", list(NN_FORMS))
def test_nearest_neighbors_call_forms(data, form):
    got = NN_FORMS[form](data)
    _same_nn(got, data)
    # the unpruned and dense routes equal the pruned one bit for bit
    want = tnops.nearest_neighbors(data["coords"], data["fe"], RB, CB,
                                   device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype.kind == "f"
                                      else g, w.view(np.int32)
                                      if w.dtype.kind == "f" else w)


def test_nearest_neighbors_xla_is_the_dense_plain_version(data):
    got = tnops.nearest_neighbors(data["coords"], data["fe"], RB, CB, "xla",
                                  device="cpu")
    want = tnops.nearest_neighbors_dense(data["coords"], data["fe"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the engines -----------------------------------------------------------------

ENGINE_FORMS = {
    "positional": lambda d: tengine.DensityEngine(d["coords"], RB, CB,
                                                  "pallas", None, "cpu"),
    "keywords": lambda d: tengine.DensityEngine(
        d["coords"], row_block=RB, col_block=CB, backend="auto", mesh=None,
        device="cpu"),
}


@pytest.mark.parametrize("form", list(ENGINE_FORMS))
@pytest.mark.parametrize("prune", [True, False])
def test_density_engine_call_forms(data, form, prune):
    eng = ENGINE_FORMS[form](data)
    got = eng.populations(RADII, prune)
    _same_pops(got, data["pops"]["pallas" if prune else "unpruned"])
    st = eng.last_stats["populations"]
    # prune, not a band radius: no band prefetch started
    assert "nn_band_prefetch" not in st and eng._band_prefetch_thread is None
    if not prune:
        # the JAX engine's unpruned plan: every tile, row-side
        assert st["mode"] == "symmetric"
        assert st["computed_tiles"] == (eng.n_pad // RB) * (eng.n_pad // CB)
    _same_nn(eng.nearest_neighbors(data["fe"], prune), data)


def test_populations_second_positional_is_prune(data):
    """``eng.populations([r], True)`` is prune=True: at r = 1.0 a band
    radius of True (== 1.0) would start the band prefetch."""
    eng = tengine.DensityEngine(data["coords"], RB, CB, device="cpu")
    want = jengine.DensityEngine(data["coords"], RB, CB, "pallas").populations(
        [1.0], True)
    _same_pops(eng.populations([1.0], True), want)
    assert "nn_band_prefetch" not in eng.last_stats["populations"]
    assert eng._band_prefetch_thread is None
    eng.populations([1.0], True, 1.0)
    assert eng.last_stats["populations"]["nn_band_prefetch"] is True
    eng.nearest_neighbors(data["fe"])


SCREEN_FORMS = {
    "positional": lambda d: tscreening.ScreeningEngine(
        d["cs"], RB, CB, "pallas", None, "cpu"),
    "keywords": lambda d: tscreening.ScreeningEngine(
        d["cs"], row_block=RB, col_block=CB, backend="auto", mesh=None,
        device="cpu"),
}


@pytest.mark.parametrize("form", list(SCREEN_FORMS))
def test_screening_engine_call_forms(data, form):
    got = SCREEN_FORMS[form](data).run(data["labels0"], data["n_below"],
                                       data["md2"])
    np.testing.assert_array_equal(got, np.asarray(data["labels"]))


LABELS_FORMS = {
    "positional": lambda d: tscreening.screening_labels(
        d["cs"], d["labels0"], d["n_below"], d["md2"], RB, CB, "pallas",
        "cpu"),
    "keywords": lambda d: tscreening.screening_labels(
        d["cs"], d["labels0"], d["n_below"], d["md2"], row_block=RB,
        col_block=CB, backend="auto", device="cpu"),
}


@pytest.mark.parametrize("form", list(LABELS_FORMS))
def test_screening_labels_call_forms(data, form):
    np.testing.assert_array_equal(LABELS_FORMS[form](data),
                                  np.asarray(data["labels"]))


SERIES_FORMS = {
    "positional": lambda d, hd: tscreening.ThresholdSeriesScreener(
        d["coords"], d["fe"], THRESHOLDS, RB, CB, "pallas", None, hd, "cpu"),
    "keywords": lambda d, hd: tscreening.ThresholdSeriesScreener(
        d["coords"], d["fe"], THRESHOLDS, row_block=RB, col_block=CB,
        backend="auto", mesh=None, hd_neighbors=hd, device="cpu"),
}


@pytest.mark.parametrize("form", list(SERIES_FORMS))
def test_series_screener_call_forms(data, form):
    nn = data["nn"]["pallas"]
    hd = (np.asarray(nn[2]), np.asarray(nn[3]))
    ts = SERIES_FORMS[form](data, hd)
    js = jscreening.ThresholdSeriesScreener(
        data["coords"], data["fe"], THRESHOLDS, RB, CB, "pallas", None, hd)
    got = want = None
    for k in range(len(THRESHOLDS)):
        got = ts.step(got, k, data["md2"])
        want = js.step(want, k, data["md2"])
        np.testing.assert_array_equal(got, np.asarray(want))
    assert len(np.unique(got)) > 2


# -- what the port does not serve ----------------------------------------------

REFUSED = {
    "populations tpu": lambda d: tdops.populations(
        d["coords"], RADII, RB, CB, "tpu", device="cpu"),
    "nearest_neighbors cuda": lambda d: tnops.nearest_neighbors(
        d["coords"], d["fe"], RB, CB, "cuda", device="cpu"),
    "DensityEngine xla": lambda d: tengine.DensityEngine(
        d["coords"], RB, CB, "xla", device="cpu"),
    "ScreeningEngine xla": lambda d: tscreening.ScreeningEngine(
        d["cs"], RB, CB, "xla", device="cpu"),
    "ThresholdSeriesScreener xla": lambda d: (
        tscreening.ThresholdSeriesScreener(
            d["coords"], d["fe"], THRESHOLDS, RB, CB, "xla", device="cpu")),
    "screening_labels xla": lambda d: tscreening.screening_labels(
        d["cs"], d["labels0"], d["n_below"], d["md2"], RB, CB, "xla",
        "cpu"),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_unserved_backends_raise(data, what):
    with pytest.raises(ValueError, match=r'backend="pallas".*device='):
        REFUSED[what](data)


def test_xla_backend_refuses_a_mesh(data):
    with pytest.raises(ValueError, match="mesh="):
        tdops.populations(data["coords"], RADII, backend="xla",
                          device="cpu", mesh=object())
    with pytest.raises(ValueError, match="mesh="):
        tnops.nearest_neighbors(data["coords"], data["fe"], backend="xla",
                                device="cpu", mesh=object())


# -- the CLI's profile trace ---------------------------------------------------

ARGV = ["density", "-f", "coords.dat", "-r", "0.3", "-p", "pop", "-d", "fe",
        "-b", "nn", "-o", "clust", "-T", "0.5", "0.5", "1.5", "-v"]


def _cli(wdir, coords, profile=None):
    wdir.mkdir()
    np.savetxt(wdir / "coords.dat", coords, fmt="%.6f")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               CLUSTERING_TORCH_DEVICE="cpu")
    env.pop("CLUSTERING_TPU_PROFILE", None)
    if profile is not None:
        env["CLUSTERING_TPU_PROFILE"] = str(profile)
    proc = subprocess.run([sys.executable, "-m", "clustering_tpu_torch"]
                          + ARGV, cwd=str(wdir), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return {f.name: [ln for ln in f.read_bytes().splitlines()
                     if not ln.startswith(b"# Created ")]
            for f in sorted(wdir.iterdir())}


def test_cli_profile_trace_holds_the_stages(data, tmp_path):
    """CLUSTERING_TPU_PROFILE=<dir>: a Chrome trace whose annotations name
    every stage; the files equal an unprofiled run's, byte for byte (but
    for the time stamp)."""
    trace_dir = tmp_path / "trace"
    plain = _cli(tmp_path / "plain", data["coords"])
    profiled = _cli(tmp_path / "profiled", data["coords"], trace_dir)
    assert sorted(plain) == sorted(profiled)
    assert "clust.1.50" in plain
    for name in plain:
        assert profiled[name] == plain[name], name
    assert sorted(p.name for p in trace_dir.iterdir()) == ["trace.json"]
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    want = {"populations", "nearest neighbors", "screening setup",
            "screening 0.50", "screening 1.00", "screening 1.50"}
    assert want <= spans, spans
