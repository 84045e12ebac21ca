"""The port's multi-rank density (``clustering_tpu_torch.parallel``) against
its single-rank engines and against the JAX package's mesh functions.

Ranks are real processes on the CPU under gloo, each its own subprocess
with a ``FileStore`` rendezvous in the test's temporary directory (no
port to race for between test workers). Each rank drops every object
that holds the process group (its mesh, engines and screener) before
``destroy_process_group``, so that gloo's threads are joined there and
not left running into the interpreter's exit, and checks that they are
gone. The two-rank CLI run rendezvouses at a ``TCPStore`` that the test
itself holds open on a port the system picked, which the ranks join as
clients (``TORCHELASTIC_USE_AGENT_STORE``), so no other process can take
the port between its choice and its use. Each rank runs
``parallel.sharded.populations`` (two radii), ``nearest_neighbors``,
``screening_labels`` and a ``ThresholdSeriesScreener`` series driven by
``step_submit``, on both sweep routes (the engines' bidirectional
switches on, then off). Every rank must be bit-identical to the port's
single-rank engines, and equal to the JAX package's
``parallel.sharded.*`` on the 8-device CPU mesh of ``tests/conftest.py``
(``backend="xla"``, as ``tests/test_distributed.py`` runs them): counts,
ids and labels exact, distances within 1 ulp (the XLA route's distance
arithmetic, ROADMAP.md C.3).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from clustering_tpu import ops as jops
from clustering_tpu import parallel as jparallel
from clustering_tpu.ops.screening import ThresholdSeriesScreener as JSeries
from clustering_tpu_torch.ops import pruning
from clustering_tpu_torch.parallel import LocalMesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
RB, CB = 8, 16
RADII = (0.3, 0.6)
THRESHOLDS = (0.4, 0.9)
N_BELOW = 120
TIMEOUT = 240
# the stats key of each stage's route (NN's "mode" is its phase 2's kind)
ROUTE_KEY = {"populations": "mode", "nn": "route", "screening": "mode"}

# one rank: argv rank, world (0: the single-rank engines, no mesh),
# store path, output path, device, n frames, row_block, col_block
_WORKER = r"""
import json, sys
from concurrent.futures import ThreadPoolExecutor
import numpy as np

rank, world, store, out, device = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
n, rb, cb = map(int, sys.argv[6:9])

from clustering_tpu_torch import ops
from clustering_tpu_torch.ops.engine import DensityEngine
from clustering_tpu_torch.ops.neighbors import compute_sigma2
from clustering_tpu_torch.ops.screening import (ScreeningEngine,
                                                ThresholdSeriesScreener)
from clustering_tpu_torch.parallel import mesh as pmesh, sharded

rng = np.random.default_rng(21)
coords = np.concatenate([
    rng.normal((0.0, 0.0), 0.15, size=(n * 9 // 16, 2)),
    rng.normal((1.5, 0.4), 0.2, size=(n - n * 9 // 16, 2)),
]).astype(np.float32)
# a lattice of spacing 1: each frame alone within 0.3, all within 100
lattice = np.stack(np.meshgrid(np.arange(5.0), np.arange(7.0)),
                   -1).reshape(-1, 2).astype(np.float32)
mesh = None
if world:
    pmesh.initialize(device, backend="gloo", init_method="file://" + store,
                     world_size=world, rank=rank)
    mesh = pmesh.make_mesh(devices=[device])

blocks = dict(row_block=rb, col_block=cb)
if mesh is None:
    def pops_fn(c, radii):
        return ops.populations(c, radii, device=device, **blocks)
    def nn_fn(c, fe):
        return ops.nearest_neighbors(c, fe, device=device, **blocks)
    def labels_fn(c, l0, nb, md2):
        return ops.screening_labels(c, l0, nb, md2, device=device, **blocks)
else:
    def pops_fn(c, radii):
        return sharded.populations(c, radii, mesh, **blocks)
    def nn_fn(c, fe):
        return sharded.nearest_neighbors(c, fe, mesh, **blocks)
    def labels_fn(c, l0, nb, md2):
        return sharded.screening_labels(c, l0, nb, md2, mesh, **blocks)

res, stats = {}, {}
for route, on in (("bidir", True), ("symmetric", False)):
    DensityEngine.POPS_BIDIR = DensityEngine.NN_BIDIR = on
    ScreeningEngine.BIDIR = on
    pops = pops_fn(coords, [0.3, 0.6])
    fe = ops.free_energies(pops[0.6])
    nn = nn_fn(coords, fe)
    md2 = np.float32(4.0 * compute_sigma2(nn[1]))
    order = np.argsort(fe, kind="stable")
    labels = labels_fn(coords[order], np.arange(n, dtype=np.int32),
                       min(120, n), md2)
    series = ThresholdSeriesScreener(coords, fe, [0.4, 0.9], device=device,
                                     mesh=mesh, **blocks)
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = [series.step_submit(k, md2, pool) for k in range(2)]
        clust = [f.result() for f in futs]
    iso = pops_fn(lattice, [0.3, 100.0])
    for key, val in dict(pops3=pops[0.3], pops6=pops[0.6], nh=nn[0],
                         nhd=nn[1], hd=nn[2], hdd=nn[3], labels=labels,
                         clust0=clust[0], clust1=clust[1], iso3=iso[0.3],
                         iso100=iso[100.0]).items():
        res[f"{route}/{key}"] = val
    # the stats of one engine per stage, as the CLI's
    eng = DensityEngine(coords, device=device, mesh=mesh, **blocks)
    eng.populations([0.6])
    eng.nearest_neighbors(fe)
    stats[route] = {"populations": eng.last_stats["populations"],
                    "nn": {k: v for k, v in eng.last_stats["nn"].items()
                           if not k.startswith("t_")},
                    "screening": series.engine.last_stats}
np.savez(out, stats=json.dumps(stats, default=str), **res)
if world:
    import gc, os, torch.distributed
    # the group's last holders: gloo's threads are joined with it
    del mesh, eng, series
    gc.collect()
    torch.distributed.destroy_process_group()
    threads = [open(f"/proc/self/task/{t}/comm").read().strip()
               for t in os.listdir("/proc/self/task")]
    assert not [t for t in threads if "gloo" in t], threads
print("RANK_OK", rank)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    for key in ("CLUSTERING_TPU_DISTRIBUTED", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    return env


def _wait(procs):
    """Wait for every process within TIMEOUT; kill them all on a timeout
    and fail with the output of any that failed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("a rank did not finish within its time limit")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{out}\n{err}"
    return outs


def run_ranks(tmp, world, device="cpu", n=160, rb=RB, cb=CB):
    """Every rank's outputs (one dict each) of ``world`` gloo ranks, or of
    the single-rank engines when ``world`` is 0."""
    tmp.mkdir(parents=True, exist_ok=True)
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    store = tmp / "store"
    outs = [tmp / f"rank{r}.npz" for r in range(max(world, 1))]
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(world), str(store),
         str(out), device, str(n), str(rb), str(cb)],
        env=_env(), cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r, out in enumerate(outs)]
    _wait(procs)
    ranks = []
    for out in outs:
        with np.load(out) as f:
            got = {k: f[k] for k in f.files if k != "stats"}
            got["stats"] = json.loads(str(f["stats"]))
        ranks.append(got)
    return ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> run_ranks(world), each run once per test process."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = run_ranks(
                tmp_path_factory.mktemp(f"world{world}"), world)
        return cache[world]
    return get


@pytest.fixture(scope="module")
def jax_mesh_results():
    """The JAX package's mesh functions on the 8-device CPU mesh."""
    rng = np.random.default_rng(21)
    n = 160
    coords = np.concatenate([
        rng.normal((0.0, 0.0), 0.15, size=(n * 9 // 16, 2)),
        rng.normal((1.5, 0.4), 0.2, size=(n - n * 9 // 16, 2)),
    ]).astype(np.float32)
    mesh = jparallel.make_mesh()
    pops = jparallel.sharded.populations(coords, list(RADII), mesh,
                                         row_block=RB, col_block=CB)
    fe = jops.free_energies(pops[0.6])
    nn = jparallel.sharded.nearest_neighbors(coords, fe, mesh, row_block=RB,
                                             col_block=CB)
    md2 = np.float32(4.0 * jops.neighbors.compute_sigma2(nn[1]))
    order = np.argsort(fe, kind="stable")
    labels = jparallel.sharded.screening_labels(
        coords[order], np.arange(n, dtype=np.int32), n_below=N_BELOW,
        max_dist2=float(md2), mesh=mesh, row_block=RB, col_block=CB)
    series = JSeries(coords, fe, [np.float32(t) for t in THRESHOLDS],
                     row_block=RB, col_block=CB, backend="xla", mesh=mesh)
    clust, prev = [], None
    for k in range(len(THRESHOLDS)):
        prev = series.step(prev, k, md2)
        clust.append(prev)
    return dict(pops3=pops[0.3], pops6=pops[0.6], nh=nn[0], nhd=nn[1],
                hd=nn[2], hdd=nn[3], labels=labels, clust0=clust[0],
                clust1=clust[1])


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


# -- the row deal -------------------------------------------------------------

@pytest.mark.parametrize("n_dev,n_rows", [(1, 37), (2, 37), (3, 37),
                                          (8, 37), (3, 0)])
def test_row_deals_partition_the_plan(n_dev, n_rows):
    """A mesh of ``n_dev`` devices deals row blocks g, g + n_dev, ... to
    device g: the deals cover every row block once, none holds more than
    ceil(nrb / n_dev), and the tile lists that the devices plan on their
    rows, with global row indices, partition the one-device list, each
    row-major sorted."""
    rng = np.random.default_rng(n_rows + n_dev)
    act = torch.from_numpy(rng.random((n_rows, 9)) < 0.5)
    deals = LocalMesh((torch.device("cpu"),) * n_dev).row_deals()
    assert [rows for _, rows in deals] == [(g, n_dev) for g in range(n_dev)]
    owned = np.concatenate([np.arange(n_rows)[g::s] for _, (g, s) in deals])
    assert sorted(owned.tolist()) == list(range(n_rows))
    want = pruning.tile_list_device(act)
    got = []
    for _, rows in deals:
        part = act[rows[0]::rows[1]]
        assert part.shape[0] == pruning.deal_rows(n_rows, rows) \
            <= -(-n_rows // n_dev)
        tiles = pruning.tile_list_device(part, rows)
        if tiles is None:
            continue
        ti, tj = (t.numpy().astype(np.int64) for t in tiles)
        assert tiles[0].dtype == torch.int32
        assert (np.diff(ti * 9 + tj) > 0).all()
        assert (ti % n_dev == rows[0]).all()
        got += list(zip(ti.tolist(), tj.tolist()))
    if want is None:
        assert not got
        return
    assert sorted(got) == list(zip(*(t.tolist() for t in want)))


# -- gloo ranks on the CPU ---------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_match_one_rank_and_jax_mesh(world, runs,
                                                jax_mesh_results):
    one = runs(0)[0]
    ranks = runs(world)
    for rank, got in enumerate(ranks):
        for key, want in one.items():
            if key == "stats":
                continue
            assert got[key].dtype == want.dtype, (rank, key)
            if want.dtype.kind == "f":
                # bit for bit
                np.testing.assert_array_equal(
                    got[key].view(np.int32), want.view(np.int32),
                    err_msg=f"rank {rank} {key}")
            else:
                np.testing.assert_array_equal(got[key], want,
                                              err_msg=f"rank {rank} {key}")
    for route in ("bidir", "symmetric"):
        for key, want in jax_mesh_results.items():
            got = ranks[0][f"{route}/{key}"]
            if key in ("nhd", "hdd"):
                assert _ulps(got, want) <= 1, (route, key)
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{route} {key}")
    assert len(np.unique(ranks[0]["bidir/clust1"])) > 2
    # each stage: every rank's list of its own rows, the ranks' lists
    # summing to the whole (every rank reads the global count)
    for route in ("bidir", "symmetric"):
        st = [r["stats"][route] for r in ranks]
        for stage, total, part in (
                ("populations", "computed_tiles", None),
                ("nn", "band_tiles", "band"),
                ("nn", "phase2_tiles", "phase2"),
                ("screening", "tiles_per_sweep", None)):
            shares = [s[stage]["per_device_tiles"] for s in st]
            if part:
                shares = [s[part] for s in shares]
            assert sum(shares) == st[0][stage][total] > 0, (route, stage)
            assert all(s[stage][total] == st[0][stage][total] for s in st)
            assert st[0][stage][ROUTE_KEY[stage]] == route + "-mesh"
            assert st[0][stage]["mesh_devices"] == world
        for stage in ("populations", "nn", "screening"):
            assert "per_device_tiles" not in one["stats"][route][stage]
            assert one["stats"][route][stage][ROUTE_KEY[stage]] == route


def test_mesh_adds_the_self_count_once_on_each_route(runs):
    """A lattice whose frames are alone within 0.3: every population is
    its self count, 1, on both routes and every rank (and N within 100)."""
    for world in (0, 2):
        for got in runs(world):
            for route in ("bidir", "symmetric"):
                iso = got[f"{route}/iso3"]
                assert (iso == 1).all(), (world, route, iso)
                assert (got[f"{route}/iso100"] == len(iso)).all()


@pytest.mark.cuda
def test_gloo_ranks_share_one_card(tmp_path):
    """2 gloo ranks on cuda:0 at 2^16 frames, default blocks: identical
    to the single-rank engines on the card, on both routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kw = dict(device="cuda:0", n=1 << 16, rb=128, cb=4096)
    one = run_ranks(tmp_path / "one", 0, **kw)[0]
    for rank, got in enumerate(run_ranks(tmp_path / "two", 2, **kw)):
        for key, want in one.items():
            if key != "stats":
                np.testing.assert_array_equal(
                    got[key], want, err_msg=f"rank {rank} {key}")


# -- the package API on two ranks --------------------------------------------

# one rank of the API run: argv rank, world (0: no mesh), store, output
_API_WORKER = r"""
import sys
import numpy as np
import torch.distributed as dist

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
import clustering_tpu_torch as ctt
from clustering_tpu_torch.parallel import mesh as pmesh

rng = np.random.default_rng(21)
coords = np.concatenate([rng.normal((0.0, 0.0), 0.15, size=(90, 2)),
                         rng.normal((1.5, 0.4), 0.2, size=(70, 2))])
kw = {"device": "cpu"}
reduces = [0]
if world:
    pmesh.initialize("cpu", backend="gloo", init_method="file://" + store,
                     world_size=world, rank=rank)
    # the JAX package's keyword alone: the device is the mesh's
    kw = {"mesh": pmesh.make_mesh(devices=["cpu"])}
    all_reduce = dist.all_reduce

    def counted(*args, **kwargs):
        reduces[0] += 1
        return all_reduce(*args, **kwargs)
    dist.all_reduce = counted
pops = ctt.populations(coords, [0.3, 0.6], **kw)
fe = ctt.free_energies(pops[0.6])
nn = ctt.nearest_neighbors(coords, fe, **kw)
clust = ctt.screening_series(coords, fe, nn.nh_dist, [0.4, 0.9],
                             hd_neighbors=(nn.nhhd_idx, nn.nhhd_dist), **kw)
np.savez(out, pops3=pops[0.3], pops6=pops[0.6], nh=nn.nh_idx,
         nhd=nn.nh_dist, hd=nn.nhhd_idx, hdd=nn.nhhd_dist,
         clust0=clust[0], clust1=clust[1], reduces=reduces[0])
if world:
    import gc
    del kw  # the mesh, the group's last holder
    gc.collect()
    dist.destroy_process_group()
"""


def test_api_takes_mesh_and_matches_one_rank(tmp_path):
    """``populations``, ``nearest_neighbors`` and ``screening_series``
    take the JAX package's ``mesh=``: on two gloo ranks each rank gets the
    single-rank results bit for bit, through all_reduce merges."""
    worker = tmp_path / "api_worker.py"
    worker.write_text(_API_WORKER)
    runs = {}
    for world in (0, 2):
        outs = [tmp_path / f"api{world}_{r}.npz" for r in range(max(world, 1))]
        _wait([subprocess.Popen(
            [sys.executable, str(worker), str(r), str(world),
             str(tmp_path / f"store{world}"), str(out)], env=_env(),
            cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for r, out in enumerate(outs)])
        runs[world] = [dict(np.load(out)) for out in outs]
    one = runs[0][0]
    assert int(one.pop("reduces")) == 0
    assert len(np.unique(one["clust1"])) > 2
    for rank, got in enumerate(runs[2]):
        assert int(got.pop("reduces")) > 0, rank
        for key, want in one.items():
            np.testing.assert_array_equal(got[key], want,
                                          err_msg=f"rank {rank} {key}")


# -- the CLI on two ranks ----------------------------------------------------

_CLI = ["density", "-f", "coords.dat", "-r", "0.3", "-p", "pop.dat", "-d",
        "fe.dat", "-b", "nn.dat", "-o", "clust", "-T", "0.4", "0.4", "1.2",
        "-v"]


def _artifact_lines(path):
    """File lines minus the volatile '# Created <timestamp>' header."""
    return [ln for ln in path.read_bytes().splitlines()
            if not ln.startswith(b"# Created ")]


def test_cli_two_ranks_write_the_single_rank_files(tmp_path):
    """density through the CLI's distributed switches on two CPU ranks:
    every rank writes every file of a single-rank run, byte for byte."""
    rng = np.random.default_rng(21)
    coords = np.concatenate([
        rng.normal((0.0, 0.0), 0.15, size=(90, 2)),
        rng.normal((1.5, 0.4), 0.2, size=(70, 2)),
    ]).astype(np.float32)
    # the rendezvous store, held open here on a port the system picked;
    # both ranks join it as clients
    store = torch.distributed.TCPStore("localhost", 0, 2, is_master=True,
                                       wait_for_workers=False)
    code = "import sys; from clustering_tpu_torch import cli; " \
           f"sys.exit(cli.main({_CLI!r}))"
    procs, dirs = [], []
    for rank in (None, 0, 1):
        wdir = tmp_path / ("single" if rank is None else f"rank{rank}")
        wdir.mkdir()
        np.savetxt(wdir / "coords.dat", coords, fmt="%.6f")
        env = _env()
        env["CLUSTERING_TORCH_DEVICE"] = "cpu"
        if rank is not None:
            env.update({"CLUSTERING_TPU_DISTRIBUTED": "1",
                        "TORCHELASTIC_USE_AGENT_STORE": "True",
                        "CLUSTERING_TPU_COORDINATOR":
                            f"localhost:{store.port}",
                        "CLUSTERING_TPU_NUM_PROCESSES": "2",
                        "CLUSTERING_TPU_PROCESS_ID": str(rank)})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=str(wdir),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        dirs.append(wdir)
    outs = _wait(procs)
    del store
    assert "[mesh screening fixpoint" not in outs[0][0]
    for out, _ in outs[1:]:
        assert "[mesh screening fixpoint" in out
    names = sorted(f.name for f in dirs[0].iterdir())
    for must in ("pop.dat", "fe.dat", "nn.dat", "clust.0.40", "clust.0.80",
                 "clust.1.20"):
        assert must in names, names
    for wdir in dirs[1:]:
        assert sorted(f.name for f in wdir.iterdir()) == names
        for name in names:
            assert _artifact_lines(wdir / name) == _artifact_lines(
                dirs[0] / name), f"{wdir.name}: {name} differs"
