"""The port's single-controller mesh: ``parallel.make_mesh()`` in a plain
process, one process driving several devices (``LocalMesh``), against
one device and against the JAX package's mesh functions.

Local meshes over ``["cpu"] * k``, k = 2, 3, 4: a device named k times
plans and sweeps the tiles of its own row blocks on buffers of its own,
and merges them as k cards would. On both sweep routes (the engines'
bidirectional switches on, then off), populations (two radii), nearest
neighbours (tiered and block-bound phase 2), ``screening_labels`` and a
``ThresholdSeriesScreener`` series must be bit-identical to one device,
each stage's shares summing to the one-device tile count; the
``parallel.sharded`` functions must agree with the JAX package's on its
k-device CPU mesh (``tests/conftest.py``), as ``test_torch_parallel``
holds the gloo ranks. The density CLI meshes every visible device when
there is more than one and no process group: with the visible-device
function patched to two CPU devices it writes the one-device files,
byte for byte.
"""

import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from clustering_tpu import cli as jcli
from clustering_tpu import ops as jops
from clustering_tpu import parallel as jparallel
from clustering_tpu.ops.screening import ThresholdSeriesScreener as JSeries
import clustering_tpu_torch as ctt
from clustering_tpu_torch import cli as tcli
from clustering_tpu_torch import ops
from clustering_tpu_torch.models import density as tdensity
from clustering_tpu_torch.ops import kernels
from clustering_tpu_torch.ops.density import free_energies
from clustering_tpu_torch.ops.engine import DensityEngine
from clustering_tpu_torch.ops.neighbors import compute_sigma2
from clustering_tpu_torch.ops.screening import (ScreeningEngine,
                                                ThresholdSeriesScreener)
from clustering_tpu_torch.parallel import LocalMesh, make_mesh, mesh_size
from clustering_tpu_torch.parallel import mesh as pmesh
from clustering_tpu_torch.parallel import sharded

import make_golden

RB, CB = 8, 16
N = 160
RADII = (0.3, 0.6)
THRESHOLDS = (0.4, 0.9)
N_BELOW = 120
SIZES = (2, 3, 4)
ROUTES = ("bidir", "symmetric")
TIER_QS = (0.5, 0.9, 0.99)
# each kernel wrapper the engines call, and the argument of its key or
# label buffer
WRAPPERS = {"pops_bidir": 0, "pops_sparse": 0, "nn_bidir": 6,
            "nn_sparse": 9, "label_min_bidir": 1, "label_min_sparse": 2}


def _coords(n=N):
    rng = np.random.default_rng(21)
    return np.concatenate([
        rng.normal((0.0, 0.0), 0.15, size=(n * 9 // 16, 2)),
        rng.normal((1.5, 0.4), 0.2, size=(n - n * 9 // 16, 2)),
    ]).astype(np.float32)


def _switches(monkeypatch, route):
    on = route == "bidir"
    monkeypatch.setattr(DensityEngine, "POPS_BIDIR", on)
    monkeypatch.setattr(DensityEngine, "NN_BIDIR", on)
    monkeypatch.setattr(ScreeningEngine, "BIDIR", on)


def _local(k):
    return make_mesh(devices=["cpu"] * k)


def _run_engines(mesh):
    """Every stage through the engines on ``mesh`` (None: one device):
    (results by name, stats by stage)."""
    coords = _coords()
    eng = DensityEngine(coords, RB, CB, device="cpu", mesh=mesh)
    pops = eng.populations(list(RADII))
    res = {"pops3": pops[0.3], "pops6": pops[0.6]}
    stats = {"populations": eng.last_stats["populations"]}
    fe = free_energies(pops[0.6])
    for tag, qs in (("tiered", TIER_QS), ("block-bound", None)):
        nn = eng.nearest_neighbors(fe, tier_qs=qs)
        for key, val in zip(("nh", "nhd", "hd", "hdd"), nn):
            res[f"{tag}/{key}"] = val
        stats[f"nn {tag}"] = eng.last_stats["nn"]
    md2 = np.float32(4.0 * compute_sigma2(res["tiered/nhd"]))
    order = np.argsort(fe, kind="stable")
    scr = ScreeningEngine(coords[order], RB, CB, device="cpu", mesh=mesh)
    res["labels"] = scr.run(np.arange(N, dtype=np.int32), N_BELOW, md2)
    stats["screening_labels"] = scr.last_stats
    series = ThresholdSeriesScreener(coords, fe, THRESHOLDS, RB, CB,
                                     mesh=mesh, device="cpu",
                                     hd_neighbors=(nn[2], nn[3]))
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = []
        for k in range(len(THRESHOLDS)):
            futs.append(series.step_submit(k, md2, pool))
            stats[f"series {k}"] = series.engine.last_stats
        for k, fut in enumerate(futs):
            res[f"clust{k}"] = fut.result()
    return res, stats


@pytest.fixture(scope="module")
def engine_runs():
    """(route, mesh size or 0) -> _run_engines, each run once per test
    process."""
    cache = {}
    mp = pytest.MonkeyPatch()

    def get(route, k):
        if (route, k) not in cache:
            with mp.context() as m:
                _switches(m, route)
                cache[route, k] = _run_engines(_local(k) if k else None)
        return cache[route, k]
    return get


def _assert_bit_equal(got, want, what):
    assert got.dtype == want.dtype, what
    if want.dtype.kind == "f":
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


# -- the engines on a local mesh against one device --------------------------

@pytest.mark.parametrize("k", SIZES)
@pytest.mark.parametrize("route", ROUTES)
def test_local_mesh_bit_identical_to_one_device(route, k, engine_runs):
    """Populations, NN ids and d^2 (tiered and block-bound), the fixpoint's
    labels and the series' clusterings, bit for bit."""
    one, _ = engine_runs(route, 0)
    got, _ = engine_runs(route, k)
    assert sorted(got) == sorted(one)
    for key, want in one.items():
        _assert_bit_equal(got[key], want, f"{route} k={k} {key}")
    assert len(np.unique(got["clust1"])) > 2


@pytest.mark.parametrize("k", SIZES)
@pytest.mark.parametrize("route", ROUTES)
def test_local_mesh_shares_sum_to_one_device_tiles(route, k, engine_runs):
    """Each stage deals its row blocks over k devices, whose lists, one
    per device, sum to the one-device list (``test_torch_mesh_rows``
    holds them disjoint, their union the one-device set); the stats say
    the route on a mesh of k devices. The row-side route keeps NN block-bound
    on a mesh (the JAX engine's rule), so its tiered request is held
    against the one-device block-bound list."""
    _, one = engine_runs(route, 0)
    _, got = engine_runs(route, k)
    cases = [("populations", "computed_tiles", None, "populations"),
             ("nn tiered", "band_tiles", "band", "nn tiered"),
             ("nn block-bound", "band_tiles", "band", "nn block-bound"),
             ("nn tiered", "phase2_tiles", "phase2",
              "nn tiered" if route == "bidir" else "nn block-bound"),
             ("nn block-bound", "phase2_tiles", "phase2", "nn block-bound"),
             ("screening_labels", "tiles_per_sweep", None,
              "screening_labels")]
    cases += [(f"series {s}", "tiles_per_sweep", None, f"series {s}")
              for s in range(len(THRESHOLDS))]
    for stage, total, part, want_stage in cases:
        st = got[stage]
        shares = st["per_device_tiles"]
        if part:
            shares = shares[part]
        assert len(shares) == k, (stage, shares)
        assert sum(shares) == one[want_stage][total] > 0, (stage, shares)
        assert st["mesh_devices"] == k
        key = "route" if stage.startswith("nn") else "mode"
        assert st[key] == route + "-mesh", (stage, st[key])
        assert "per_device_tiles" not in one[stage]
    assert got["nn tiered"]["mode"] == one["nn tiered" if route == "bidir"
                                           else "nn block-bound"]["mode"]


# -- against the JAX package's mesh ------------------------------------------

def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _boundary_ties(coords, radius):
    """Per frame, the pairs whose distance lies within 4 ulps of the
    radius: the counts there may differ between the fma chain and the
    XLA route's arithmetic (ROADMAP's distance classes)."""
    x = coords.astype(np.float64)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    r2 = np.float32(radius) * np.float32(radius)
    return (np.abs(d2 - r2) <= 4 * np.spacing(r2)).sum(axis=1)


@pytest.fixture(scope="module")
def jax_mesh_runs():
    """k -> the JAX package's ``parallel.sharded`` functions and series on
    its first k CPU devices (``backend="xla"``, as
    ``tests/test_distributed.py`` runs them)."""
    cache = {}

    def get(k):
        if k not in cache:
            coords = _coords()
            mesh = jparallel.make_mesh(k)
            pops = jparallel.sharded.populations(
                coords, list(RADII), mesh, row_block=RB, col_block=CB)
            fe = jops.free_energies(pops[0.6])
            nn = jparallel.sharded.nearest_neighbors(
                coords, fe, mesh, row_block=RB, col_block=CB)
            md2 = np.float32(4.0 * jops.neighbors.compute_sigma2(nn[1]))
            order = np.argsort(fe, kind="stable")
            labels = jparallel.sharded.screening_labels(
                coords[order], np.arange(N, dtype=np.int32),
                n_below=N_BELOW, max_dist2=float(md2), mesh=mesh,
                row_block=RB, col_block=CB)
            series = JSeries(coords, fe, [np.float32(t) for t in THRESHOLDS],
                             row_block=RB, col_block=CB, backend="xla",
                             mesh=mesh)
            res = dict(pops3=pops[0.3], pops6=pops[0.6], nh=nn[0],
                       nhd=nn[1], hd=nn[2], hdd=nn[3], labels=labels)
            prev = None
            for s in range(len(THRESHOLDS)):
                prev = series.step(prev, s, md2)
                res[f"clust{s}"] = prev
            cache[k] = res
        return cache[k]
    return get


@pytest.mark.parametrize("k", SIZES)
def test_local_mesh_sharded_matches_jax_mesh(k, jax_mesh_runs, monkeypatch):
    """``parallel.sharded`` and the series on a local mesh of k CPU devices
    against the JAX package's on its k-device CPU mesh, both routes:
    counts exact up to radius-boundary ties (none on this data), ids and
    labels exact, d^2 within 1 ulp (the XLA route's distance arithmetic,
    the tolerance of ``test_torch_parallel``'s JAX mesh check)."""
    coords = _coords()
    want = jax_mesh_runs(k)
    for route in ROUTES:
        _switches(monkeypatch, route)
        mesh = _local(k)
        blocks = dict(row_block=RB, col_block=CB)
        pops = sharded.populations(coords, list(RADII), mesh, **blocks)
        fe = free_energies(pops[0.6])
        nn = sharded.nearest_neighbors(coords, fe, mesh, **blocks)
        md2 = np.float32(4.0 * compute_sigma2(nn[1]))
        order = np.argsort(fe, kind="stable")
        got = dict(pops3=pops[0.3], pops6=pops[0.6], nh=nn[0], nhd=nn[1],
                   hd=nn[2], hdd=nn[3], labels=sharded.screening_labels(
                       coords[order], np.arange(N, dtype=np.int32), N_BELOW,
                       md2, mesh, **blocks))
        series = ThresholdSeriesScreener(coords, fe, THRESHOLDS, mesh=mesh,
                                         **blocks)
        prev = None
        for s in range(len(THRESHOLDS)):
            prev = series.step(prev, s, md2)
            got[f"clust{s}"] = prev
        for r, key in zip(RADII, ("pops3", "pops6")):
            ties = _boundary_ties(coords, r)
            assert (np.abs(got[key] - want[key]) <= ties).all(), (route, key)
        for key in ("nhd", "hdd"):
            assert _ulps(got[key], want[key]) <= 1, (route, key)
        for key in ("nh", "hd", "labels", "clust0", "clust1"):
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{route} {key}")


# -- buffers, launches and failures ------------------------------------------

def _spy(monkeypatch, events):
    """Wrap every kernel wrapper the engines call: each call appends
    (name, its key or label buffer, its coordinates) to ``events``."""
    for name, arg in WRAPPERS.items():
        fn = getattr(kernels, name)

        def call(*args, _fn=fn, _name=name, _arg=arg):
            events.append((_name, args[_arg], args[0]))
            return _fn(*args)
        monkeypatch.setattr(kernels, name, call)


@pytest.mark.parametrize("k", SIZES)
@pytest.mark.parametrize("route", ROUTES)
def test_local_mesh_shares_have_their_own_buffers(route, k, monkeypatch):
    """The k calls of one sweep get k distinct key buffers (NN), label
    buffers (screening) and coordinate copies, none sharing storage with
    another, though every device is the CPU: a buffer folded into by two
    shares would hide the merge, since a MIN is idempotent."""
    _switches(monkeypatch, route)
    events = []
    _spy(monkeypatch, events)
    _run_engines(_local(k))
    assert len(events) % k == 0 and events
    for i in range(0, len(events), k):
        group = events[i:i + k]
        assert len({name for name, _, _ in group}) == 1, group
        for slot in (1, 2):
            ptrs = {t.untyped_storage().data_ptr() for t in
                    (ev[slot] for ev in group)}
            assert len(ptrs) == k, (group[0][0], slot)
    t = torch.arange(6)
    copies = LocalMesh((torch.device("cpu"),) * k).copies(t)
    assert copies[0] is t
    assert len({c.untyped_storage().data_ptr() for c in copies}) == k


@pytest.mark.parametrize("route", ROUTES)
def test_local_mesh_launches_every_share_before_a_readback(route,
                                                           monkeypatch):
    """No host readback between the shares of one stage call: every
    device's share is launched before the stage reads anything back (a
    readback between them would run the cards one after another). The
    calls come in runs of k with no ``bool``, ``int``, ``item``,
    ``tolist`` or ``cpu`` of a tensor inside a run on the thread that
    launches them (the series' pool downloads finished labels beside
    it)."""
    k = 3
    _switches(monkeypatch, route)
    events = []
    _spy(monkeypatch, events)
    me = threading.get_ident()
    for name in ("__bool__", "__int__", "item", "tolist", "cpu"):
        fn = getattr(torch.Tensor, name)

        def readback(self, *args, _fn=fn, **kw):
            if threading.get_ident() == me:
                events.append(("readback", None, None))
            return _fn(self, *args, **kw)
        monkeypatch.setattr(torch.Tensor, name, readback)
    _run_engines(_local(k))
    run = 0
    for name, _, _ in events + [("readback", None, None)]:
        if name == "readback":
            assert run % k == 0, run
            run = 0
        else:
            run += 1
    assert sum(name != "readback" for name, _, _ in events) % k == 0


@pytest.mark.parametrize("stage", ["populations", "nearest neighbors",
                                   "screening"])
def test_local_mesh_share_failure_raises(stage, monkeypatch):
    """A share whose launch fails raises out of the stage: nothing falls
    back to another device or to fewer shares."""
    mesh = _local(2)
    coords = _coords()
    name = {"populations": "pops_bidir", "nearest neighbors": "nn_bidir",
            "screening": "label_min_bidir"}[stage]
    calls = []
    fn = getattr(kernels, name)

    def second_fails(*args):
        calls.append(name)
        if len(calls) == 2:
            raise RuntimeError(f"{name}: CUDA launch failed (cudaError 700)")
        return fn(*args)
    eng = DensityEngine(coords, RB, CB, mesh=mesh)
    fe = free_energies(eng.populations([0.6])[0.6])
    order = np.argsort(fe, kind="stable")
    monkeypatch.setattr(kernels, name, second_fails)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        if stage == "populations":
            eng.populations([0.6])
        elif stage == "nearest neighbors":
            eng.nearest_neighbors(fe)
        else:
            ScreeningEngine(coords[order], RB, CB, mesh=mesh).run(
                np.arange(N, dtype=np.int32), N_BELOW, 0.05)
    assert len(calls) == 2


# -- make_mesh, the API and the sharded keywords -----------------------------

def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


MESH_FORMS = {
    # no card and no devices: a clear error, never the CPU
    "no-card": lambda: make_mesh(),
    "no-card-n": lambda: make_mesh(n_devices=2),
    "empty": lambda: make_mesh(devices=[]),
    "mixed": lambda: make_mesh(devices=["cpu", "meta"]),
    "engine-elsewhere": lambda: DensityEngine(
        _coords(), RB, CB, device="cuda", mesh=_local(2)),
}
MESH_ERRORS = {"no-card": RuntimeError, "no-card-n": RuntimeError,
               "empty": ValueError, "mixed": ValueError,
               "engine-elsewhere": ValueError}


@pytest.mark.parametrize("form", sorted(MESH_FORMS))
def test_make_mesh_refuses(form, monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(MESH_ERRORS[form]):
        MESH_FORMS[form]()


@pytest.mark.parametrize("k", SIZES)
def test_make_mesh_takes_the_jax_signature(k, monkeypatch):
    """``make_mesh(n_devices, devices)`` in a plain process: ``devices``
    as given (a device may repeat), else the first ``n_devices`` of
    ``visible_devices()`` (all by default), the first one primary."""
    mesh = make_mesh(devices=["cpu"] * k)
    assert isinstance(mesh, LocalMesh) and mesh_size(mesh) == k
    assert mesh.devices == (torch.device("cpu"),) * k
    assert mesh.device == torch.device("cpu")
    visible = [torch.device("cpu")] * 4
    monkeypatch.setattr(pmesh, "visible_devices", lambda device="cuda":
                        visible)
    assert make_mesh().size == 4
    assert make_mesh(n_devices=k).devices == tuple(visible[:k])
    # the density CLI's rule: a mesh only over more than one device
    assert tdensity.run_mesh(torch.device("cpu")).size == 4
    monkeypatch.setattr(pmesh, "visible_devices", lambda device="cuda":
                        [torch.device(device)])
    assert tdensity.run_mesh(torch.device("cpu")) is None


@pytest.mark.parametrize("k", SIZES)
def test_api_takes_a_local_mesh(k):
    """``populations``, ``nearest_neighbors`` and ``screening_series`` with
    ``mesh=`` a local mesh (the device is the mesh's): the one-device
    results, bit for bit."""
    coords = _coords()
    got, want = {}, {}
    for out, kw in ((want, {"device": "cpu"}), (got, {"mesh": _local(k)})):
        pops = ctt.populations(coords, list(RADII), **kw)
        fe = ctt.free_energies(pops[0.6])
        nn = ctt.nearest_neighbors(coords, fe, **kw)
        clust = ctt.screening_series(
            coords, fe, nn.nh_dist, THRESHOLDS,
            hd_neighbors=(nn.nhhd_idx, nn.nhhd_dist), **kw)
        out.update(pops3=pops[0.3], pops6=pops[0.6], clust0=clust[0],
                   clust1=clust[1], **nn._asdict())
    for key, val in want.items():
        _assert_bit_equal(got[key], val, key)


SHARDED_CALLS = ("populations", "nearest_neighbors", "screening_labels")


@pytest.mark.parametrize("fn", SHARDED_CALLS)
def test_sharded_takes_the_jax_keywords(fn):
    """The JAX functions' ``backend``, ``prune`` and ``band_blocks``
    keywords: "pallas" (and "auto") is the tile route and equals the ops
    function with the same keywords on one device; "xla" on a mesh and
    any other backend raise ValueError."""
    coords = _coords()
    mesh = _local(3)
    blocks = dict(row_block=RB, col_block=CB)
    fe = free_energies(ops.populations(coords, [0.6], device="cpu",
                                       **blocks)[0.6])
    order = np.argsort(fe, kind="stable")
    if fn == "populations":
        def call(m, **kw):
            return sharded.populations(coords, list(RADII), m, **blocks,
                                       prune=False, **kw)
        want = ops.populations(coords, list(RADII), prune=False,
                               device="cpu", **blocks)
        want = [want[r] for r in RADII]
        got = call(mesh, backend="pallas")
        got = [got[r] for r in RADII]
    elif fn == "nearest_neighbors":
        def call(m, **kw):
            return sharded.nearest_neighbors(coords, fe, m, **blocks,
                                             prune=True, band_blocks=2, **kw)
        want = DensityEngine(coords, device="cpu", **blocks)
        want = want.nearest_neighbors(fe, band_blocks=2)
        got = call(mesh, backend="pallas")
    else:
        def call(m, **kw):
            return sharded.screening_labels(
                coords[order], np.arange(N, dtype=np.int32), N_BELOW, 0.05,
                m, **blocks, **kw)
        want = [ops.screening_labels(coords[order],
                                     np.arange(N, dtype=np.int32), N_BELOW,
                                     0.05, device="cpu", **blocks)]
        got = [call(mesh, backend="pallas")]
    for g, w in zip(got, want):
        _assert_bit_equal(np.asarray(g), np.asarray(w), fn)
    for backend in ("xla", "cuda"):
        with pytest.raises(ValueError):
            call(mesh, backend=backend)


# -- the density CLI ---------------------------------------------------------

_ARGV = ["density", "-f", "coords.dat", "-r", "0.3", "-p", "pop", "-d", "fe",
         "-b", "nn", "-o", "clust", "-T", "0.4", "0.4", "1.2", "-v"]


def _small_blocks(monkeypatch):
    """The CLI's engine and screener on blocks (RB, CB), so that a few
    hundred frames fill many tiles; returns the list of the meshes its
    engines were given."""
    meshes = []

    def engine(*args, **kw):
        meshes.append(kw.get("mesh"))
        return DensityEngine(*args, row_block=RB, col_block=CB, **kw)
    monkeypatch.setattr(tdensity, "DensityEngine", engine)
    monkeypatch.setattr(tdensity, "ThresholdSeriesScreener",
                        functools.partial(ThresholdSeriesScreener,
                                          row_block=RB, col_block=CB))
    return meshes


def _two_cpus(monkeypatch):
    monkeypatch.setattr(pmesh, "visible_devices", lambda device="cuda":
                        [torch.device("cpu")] * 2)


def _artifact_lines(path):
    """File lines minus the volatile '# Created <timestamp>' header."""
    return [ln for ln in path.read_bytes().splitlines()
            if not ln.startswith(b"# Created ")]


@pytest.mark.parametrize("route", ROUTES)
def test_local_mesh_cli_writes_one_device_files(route, tmp_path, monkeypatch,
                                                capsys):
    """The density CLI in this process, once on one CPU device, once with
    the visible-device function patched to two CPU devices: it meshes
    them (its log says so, and each fixpoint runs on the mesh) and writes
    every file of the one-device run, byte for byte, once."""
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    _switches(monkeypatch, route)
    _small_blocks(monkeypatch)
    outs, dirs = [], []
    for name in ("one", "mesh"):
        wdir = tmp_path / name
        wdir.mkdir()
        np.savetxt(wdir / "coords.dat", _coords(300), fmt="%.6f")
        monkeypatch.chdir(wdir)
        with monkeypatch.context() as m:
            if name == "mesh":
                _two_cpus(m)
            assert tcli.main(_ARGV) == 0
        outs.append(capsys.readouterr().out)
        dirs.append(wdir)
    assert "mesh" not in outs[0]
    assert "~~~ mesh of 2 devices: cpu, cpu" in outs[1]
    assert outs[1].count("[mesh screening fixpoint") == 3
    names = sorted(f.name for f in dirs[0].iterdir())
    assert sorted(f.name for f in dirs[1].iterdir()) == names
    for must in ("pop", "fe", "nn", "clust.0.40", "clust.0.80",
                 "clust.1.20"):
        assert must in names, names
    for name in names:
        assert _artifact_lines(dirs[1] / name) == _artifact_lines(
            dirs[0] / name), name


def test_local_mesh_golden_chain_through_port_cli(tmp_path, monkeypatch):
    """make_golden's whole argv chain through the port's CLI with the
    visible-device function patched to two CPU devices and blocks (RB,
    CB): every file byte-equal to tests/golden/ except the nn distance
    columns, which may differ in the last of their 6 printed digits, as in
    ``test_torch_density``'s chain on one device."""
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    meshes = _small_blocks(monkeypatch)
    _two_cpus(monkeypatch)
    runs = []
    main = tcli.main

    def run(argv):
        runs.append(argv[0])
        return main(argv)
    monkeypatch.setattr(jcli, "main", run)
    make_golden.generate(str(tmp_path))
    assert runs.count("density") == 2
    assert [m.devices for m in meshes] == [(torch.device("cpu"),) * 2] * 2
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
