"""The port's process-group mesh with several devices per rank: each rank
of a group drives its own devices and the density stages deal the row
blocks over all devices of all ranks, by global device index, each
device planning and sweeping its own rows, as the JAX package's
multi-process mesh spans every device (``tests/test_distributed.py``: 2
processes x 4 devices, one 8-device mesh).

Ranks are gloo processes on the CPU with a ``FileStore`` rendezvous, as
in ``test_torch_parallel``; each is given its devices as ``["cpu"] * k``,
for the splits [2, 2], [1, 3] and [4, 4]. On both sweep routes every
rank runs ``parallel.sharded.populations`` (radii 0.3 and 0.6),
``nearest_neighbors``, ``screening_labels`` and a
``ThresholdSeriesScreener`` series: each rank must be bit-identical to
one device; each of its devices' ``per_device_tiles`` must equal a
``LocalMesh`` of the same global size at that device's global index, and
``mesh_devices`` the global count; the results must equal the JAX
package's ``parallel.sharded.*`` on a CPU mesh of that size (counts, ids
and labels exact, distances within 1 ulp). The ranks also hold
``make_mesh``'s refusals in a group. The host rule, which decides a
rank's default devices, is held as a pure function, and the density CLI
under the distributed switches on two ranks of two patched CPU devices
each must write the single-process files.
"""

import json
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from clustering_tpu_torch import ops
from clustering_tpu_torch.ops import engine as tengine
from clustering_tpu_torch.ops.engine import DensityEngine
from clustering_tpu_torch.ops.neighbors import compute_sigma2
from clustering_tpu_torch.ops.screening import (ScreeningEngine,
                                                ThresholdSeriesScreener)
from clustering_tpu_torch.parallel import (LocalMesh, Mesh, host_devices,
                                           rank_devices, sharded)
from clustering_tpu_torch.parallel import mesh as pmesh

TESTS = pathlib.Path(__file__).resolve().parent
N = 160
RB, CB = 8, 16
RADII = (0.3, 0.6)
THRESHOLDS = (0.4, 0.9)
N_BELOW = 120
ROUTES = (("bidir", True), ("symmetric", False))
# each rank's device count
SPLITS = {"2+2": (2, 2), "1+3": (1, 3), "4+4": (4, 4)}
# the stats key of each stage's route (NN's "mode" is its phase 2's kind)
ROUTE_KEY = {"populations": "mode", "nn": "route", "screening": "mode"}


def _coords():
    rng = np.random.default_rng(21)
    return np.concatenate([
        rng.normal((0.0, 0.0), 0.15, size=(N * 9 // 16, 2)),
        rng.normal((1.5, 0.4), 0.2, size=(N - N * 9 // 16, 2)),
    ]).astype(np.float32)


def compute(mesh):
    """Every stage on ``mesh`` (None: one CPU device) on both routes, as
    each rank runs it. Returns (results by "route/name", each route's
    stage stats, with their route, ``mesh_devices`` and
    ``per_device_tiles``); the engines' switches are restored after."""
    coords = _coords()
    blocks = dict(row_block=RB, col_block=CB)
    saved = (DensityEngine.POPS_BIDIR, DensityEngine.NN_BIDIR,
             ScreeningEngine.BIDIR)
    res, stats = {}, {}
    try:
        for route, on in ROUTES:
            DensityEngine.POPS_BIDIR = DensityEngine.NN_BIDIR = on
            ScreeningEngine.BIDIR = on
            if mesh is None:
                pops = ops.populations(coords, list(RADII), device="cpu",
                                       **blocks)
                fe = ops.free_energies(pops[0.6])
                nn = ops.nearest_neighbors(coords, fe, device="cpu",
                                           **blocks)
            else:
                pops = sharded.populations(coords, list(RADII), mesh,
                                           **blocks)
                fe = ops.free_energies(pops[0.6])
                nn = sharded.nearest_neighbors(coords, fe, mesh, **blocks)
            md2 = np.float32(4.0 * compute_sigma2(nn[1]))
            order = np.argsort(fe, kind="stable")
            args = (coords[order], np.arange(N, dtype=np.int32), N_BELOW,
                    md2)
            labels = (ops.screening_labels(*args, device="cpu", **blocks)
                      if mesh is None
                      else sharded.screening_labels(*args, mesh, **blocks))
            series = ThresholdSeriesScreener(coords, fe, THRESHOLDS,
                                             device="cpu", mesh=mesh,
                                             **blocks)
            with ThreadPoolExecutor(max_workers=2) as pool:
                futs = [series.step_submit(k, md2, pool)
                        for k in range(len(THRESHOLDS))]
                clust = [f.result() for f in futs]
            for key, val in dict(pops3=pops[0.3], pops6=pops[0.6], nh=nn[0],
                                 nhd=nn[1], hd=nn[2], hdd=nn[3],
                                 labels=labels, clust0=clust[0],
                                 clust1=clust[1]).items():
                res[f"{route}/{key}"] = val
            # one engine per stage's stats, as the CLI's
            eng = DensityEngine(coords, device="cpu", mesh=mesh, **blocks)
            eng.populations(list(RADII))
            eng.nearest_neighbors(fe)
            stats[route] = {
                "populations": eng.last_stats["populations"],
                "nn": {k: v for k, v in eng.last_stats["nn"].items()
                       if not k.startswith("t_")},
                "screening": series.engine.last_stats}
    finally:
        (DensityEngine.POPS_BIDIR, DensityEngine.NN_BIDIR,
         ScreeningEngine.BIDIR) = saved
    return res, json.loads(json.dumps(stats, default=str))


# one rank: argv rank, its devices per rank (comma-separated), store
# path, output path
_WORKER = r"""
import gc, json, sys
import numpy as np
import torch.distributed as dist

rank, split, store, out = (int(sys.argv[1]),
                           [int(k) for k in sys.argv[2].split(",")],
                           sys.argv[3], sys.argv[4])
from clustering_tpu_torch.parallel import mesh as pmesh
from test_torch_group_mesh import compute

pmesh.initialize("cpu", backend="gloo", init_method="file://" + store,
                 world_size=len(split), rank=rank)
mine = ["cpu"] * split[rank]
refused = {}
# the old meaning of n_devices (the world size), an empty list, two types
for form, kw in (("n_devices", dict(n_devices=len(split), devices=mine)),
                 ("empty", dict(devices=[])),
                 ("mixed", dict(devices=["cpu", "meta"]))):
    try:
        pmesh.make_mesh(**kw)
        refused[form] = None
    except ValueError as exc:
        refused[form] = str(exc)
full = pmesh.make_mesh(n_devices=sum(split), devices=mine)
mesh = pmesh.make_mesh(devices=mine)
layout = dict(rank=mesh.rank, offset=mesh.offset, size=mesh.size,
              deals=[list(rows) for _, rows in mesh.row_deals()],
              devices=[str(d) for d in mesh.devices],
              full_size=full.size)
# the host-name gather as under NCCL: through a gloo group of its own
backend = dist.get_backend
dist.get_backend = lambda group=None: "nccl"
side = pmesh._all_gather(rank * 10)
dist.get_backend = backend
reduces = [0]
all_reduce = dist.all_reduce

def counted(*args, **kwargs):
    reduces[0] += 1
    return all_reduce(*args, **kwargs)

dist.all_reduce = counted
res, stats = compute(mesh)
meta = dict(stats=stats, refused=refused, layout=layout, reduces=reduces[0],
            side=side)
np.savez(out, meta=json.dumps(meta), **res)
# the group's last holders: gloo's threads are joined with it
del mesh, full
gc.collect()
dist.destroy_process_group()
print("RANK_OK", rank)
"""


def _group_env():
    from test_torch_parallel import _env
    env = _env()
    env["PYTHONPATH"] = str(TESTS) + os.pathsep + env["PYTHONPATH"]
    return env


def run_split(tmp, split):
    """Each rank's (results, meta) of a gloo group whose rank r drives
    ``split[r]`` CPU devices."""
    # imported here: test_torch_parallel imports the JAX package, which a
    # rank (importing this module) need not load
    from test_torch_parallel import _wait
    tmp.mkdir(parents=True, exist_ok=True)
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    outs = [tmp / f"rank{r}.npz" for r in range(len(split))]
    _wait([subprocess.Popen(
        [sys.executable, str(worker), str(r), ",".join(map(str, split)),
         str(tmp / "store"), str(out)], env=_group_env(), cwd=str(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r, out in enumerate(outs)])
    ranks = []
    for out in outs:
        with np.load(out) as f:
            ranks.append(({k: f[k] for k in f.files if k != "meta"},
                          json.loads(str(f["meta"]))))
    return ranks


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """split name -> run_split, each group spawned once per test process."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_split(tmp_path_factory.mktemp(name),
                                    SPLITS[name])
        return cache[name]
    return get


@pytest.fixture(scope="module")
def local_runs():
    """Global size (0: one device, no mesh) -> ``compute`` on a
    ``LocalMesh`` of that many CPU devices."""
    cache = {}

    def get(size):
        if size not in cache:
            cache[size] = compute(
                LocalMesh((torch.device("cpu"),) * size) if size else None)
        return cache[size]
    return get


@pytest.fixture(scope="module")
def jax_runs():
    """Global size -> the JAX package's ``parallel.sharded`` functions and
    series on its first ``size`` CPU devices (``tests/conftest.py``),
    ``backend="xla"`` as ``tests/test_distributed.py`` runs them."""
    from clustering_tpu import ops as jops
    from clustering_tpu import parallel as jparallel
    from clustering_tpu.ops.screening import ThresholdSeriesScreener as JSeries
    cache = {}

    def get(size):
        if size not in cache:
            coords = _coords()
            mesh = jparallel.make_mesh(size)
            blocks = dict(row_block=RB, col_block=CB)
            pops = jparallel.sharded.populations(coords, list(RADII), mesh,
                                                 **blocks)
            fe = jops.free_energies(pops[0.6])
            nn = jparallel.sharded.nearest_neighbors(coords, fe, mesh,
                                                     **blocks)
            md2 = np.float32(4.0 * jops.neighbors.compute_sigma2(nn[1]))
            order = np.argsort(fe, kind="stable")
            labels = jparallel.sharded.screening_labels(
                coords[order], np.arange(N, dtype=np.int32), n_below=N_BELOW,
                max_dist2=float(md2), mesh=mesh, **blocks)
            series = JSeries(coords, fe, [np.float32(t) for t in THRESHOLDS],
                             backend="xla", mesh=mesh, **blocks)
            res = dict(pops3=pops[0.3], pops6=pops[0.6], nh=nn[0],
                       nhd=nn[1], hd=nn[2], hdd=nn[3], labels=labels)
            prev = None
            for s in range(len(THRESHOLDS)):
                prev = series.step(prev, s, md2)
                res[f"clust{s}"] = prev
            cache[size] = res
        return cache[size]
    return get


def _stage_shares(stats, route):
    """(stage, its per_device_tiles, its route's stats key) of a run."""
    st = stats[route]
    return [("populations", st["populations"].get("per_device_tiles")),
            ("nn band", (st["nn"].get("per_device_tiles") or {}).get("band")),
            ("nn phase 2",
             (st["nn"].get("per_device_tiles") or {}).get("phase2")),
            ("screening", st["screening"].get("per_device_tiles"))]


# -- the group's ranks against one device, a local mesh and JAX --------------

@pytest.mark.parametrize("split", sorted(SPLITS))
def test_group_mesh_bit_identical_to_one_device(split, groups, local_runs):
    """Every rank's populations, NN ids and d^2, fixpoint labels and
    series clusterings, on both routes, bit for bit against one device;
    every rank made the same number of merges (an empty share merges
    too)."""
    one, _ = local_runs(0)
    ranks = groups(split)
    assert len({meta["reduces"] for _, meta in ranks}) == 1
    assert ranks[0][1]["reduces"] > 0
    for rank, (got, _) in enumerate(ranks):
        assert sorted(got) == sorted(one)
        for key, want in one.items():
            assert got[key].dtype == want.dtype, (rank, key)
            bits = np.int32 if want.dtype.kind == "f" else want.dtype
            np.testing.assert_array_equal(got[key].view(bits),
                                          want.view(bits),
                                          err_msg=f"{split} rank {rank} {key}")
    assert len(np.unique(ranks[0][0]["bidir/clust1"])) > 2


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_group_mesh_shares_are_the_local_deal(split, groups, local_runs):
    """The mesh spans every rank's devices: ``offset`` is the sum of the
    lower ranks' device counts, ``size`` and ``mesh_devices`` the global
    count; each device owns the row blocks of its global index g,
    ``g, g + size, ...``, as a LocalMesh of the global size deals them;
    each stage's ``per_device_tiles`` on rank r (a list over its
    devices, or its int with one device) equals that LocalMesh's at the
    device's global index, on both routes (``test_torch_mesh_rows``
    holds a local mesh's lists disjoint, their union the one-device
    list)."""
    counts = SPLITS[split]
    size = sum(counts)
    _, local = local_runs(size)
    for rank, (_, meta) in enumerate(groups(split)):
        lay = meta["layout"]
        offset = sum(counts[:rank])
        assert (lay["rank"], lay["offset"], lay["size"]) == (rank, offset,
                                                             size)
        assert lay["devices"] == ["cpu"] * counts[rank]
        assert lay["deals"] == [[offset + k, size]
                                for k in range(counts[rank])]
        assert lay["full_size"] == size
        for route, _ in ROUTES:
            st = meta["stats"][route]
            for stage, key in ROUTE_KEY.items():
                assert st[stage][key] == route + "-mesh", (route, stage)
                assert st[stage]["mesh_devices"] == size
            for (stage, got), (_, want) in zip(
                    _stage_shares(meta["stats"], route),
                    _stage_shares(local, route)):
                want = want[offset:offset + counts[rank]]
                if counts[rank] == 1:
                    want = want[0]
                assert got == want, (split, rank, route, stage)


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_group_mesh_matches_the_jax_mesh(split, groups, jax_runs):
    """Rank 0 on both routes against the JAX package's mesh functions on a
    CPU mesh of the global size: counts, ids and labels exact, d^2 within
    1 ulp (the XLA route's distance arithmetic, ROADMAP C5)."""
    from test_torch_parallel import _ulps
    want = jax_runs(sum(SPLITS[split]))
    got = groups(split)[0][0]
    for route, _ in ROUTES:
        for key, val in want.items():
            mine = got[f"{route}/{key}"]
            if key in ("nhd", "hdd"):
                assert _ulps(mine, val) <= 1, (route, key)
            else:
                np.testing.assert_array_equal(mine, val,
                                              err_msg=f"{route} {key}")


@pytest.mark.parametrize("form", ["n_devices", "empty", "mixed"])
def test_make_mesh_refuses_in_a_group(form, groups):
    """In a group ``make_mesh`` raises ValueError on every rank for an
    ``n_devices`` other than the global device count (here the world
    size, the count a mesh of one device per rank had), an empty device
    list and a list of two device types."""
    for _, meta in groups("2+2"):
        assert meta["refused"][form], form


def test_gather_beside_another_backend(groups):
    """Under a backend other than gloo (NCCL on the cards) the host-name
    gather runs on a gloo group of its own, torn down after: every rank
    gets every rank's object, in rank order."""
    for _, meta in groups("2+2"):
        assert meta["side"] == [0, 10]


def test_group_mesh_copies_do_not_alias():
    """A group mesh's copies on a repeated device are buffers of their
    own, as a local mesh's are (a MIN into one shared buffer would hide
    the merge)."""
    mesh = Mesh(None, 0, (torch.device("cpu"),) * 3, 0, 3)
    t = torch.arange(6)
    copies = mesh.copies(t)
    assert copies[0] is t
    assert len({c.untyped_storage().data_ptr() for c in copies}) == 3
    assert mesh.device == torch.device("cpu")


# -- the host rule -----------------------------------------------------------

CARDS = [torch.device("cuda", i) for i in range(4)]
HOST_CASES = {
    # (visible, rank, hosts, env) -> devices
    "alone-takes-every-card": (CARDS, 1, ["a", "b"], {}, CARDS),
    "alone-of-one": (CARDS, 0, ["a"], {}, CARDS),
    "two-on-a-host": (CARDS, 1, ["a", "a"], {}, [CARDS[1]]),
    "four-on-a-host": (CARDS, 3, ["a"] * 4, {}, [CARDS[3]]),
    "interleaved-hosts": (CARDS, 2, ["a", "b", "a", "b"], {}, [CARDS[1]]),
    "env-over-hosts": (CARDS, 0, ["a", "b"],
                       {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"},
                       [CARDS[1]]),
    "env-alone": (CARDS, 1, ["a", "a"],
                  {"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}, CARDS),
    "env-without-hosts": (CARDS, 5, None,
                          {"LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "4"},
                          [CARDS[2]]),
    "cpu-ranks-share-the-cpu": ([torch.device("cpu")], 1, ["a", "a"], {},
                                [torch.device("cpu")]),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_rule(case):
    visible, rank, hosts, env, want = HOST_CASES[case]
    assert host_devices(visible, rank, hosts, env) == want


@pytest.mark.parametrize("ranks", [2, 4])
def test_host_rule_never_gives_a_card_twice(ranks):
    """Ranks that share a host take one card each, all different; a rank
    alone on its host takes them all."""
    got = [host_devices(CARDS, r, ["a"] * ranks + ["b"]) for r in
           range(ranks + 1)]
    assert all(len(g) == 1 for g in got[:ranks])
    assert len({g[0] for g in got[:ranks]}) == ranks
    assert got[ranks] == CARDS


@pytest.mark.parametrize("visible,hosts", [(CARDS[:2], ["a"] * 3),
                                           ([], ["a"])])
def test_host_rule_refuses(visible, hosts):
    """More ranks on a host than its cards, or no card: RuntimeError."""
    with pytest.raises(RuntimeError):
        host_devices(visible, 0, hosts)


@pytest.mark.parametrize("hosts,want", [(["h0", "h0"], [CARDS[1]]),
                                        (["h0", "h1"], CARDS)])
def test_resolve_device_takes_the_host_rule(hosts, want, monkeypatch):
    """In a group, ``rank_devices`` applies the rule to the gathered host
    names, and ``resolve_device("cuda")`` is its first device: rank 1 of
    two on one host gets cuda:1, alone on its host cuda:0 (of all four)."""
    for key in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(pmesh, "_all_gather", lambda obj: list(hosts))
    assert rank_devices() == want
    assert tengine.resolve_device("cuda") == want[0]
    assert tengine.resolve_device("cuda:3") == CARDS[3]


# -- the density CLI on two ranks of two devices -----------------------------

_CLI = ["density", "-f", "coords.dat", "-r", "0.3", "-p", "pop.dat", "-d",
        "fe.dat", "-b", "nn.dat", "-o", "clust", "-T", "0.4", "0.4", "1.2",
        "-v"]

# the CLI on blocks (RB, CB); with an argument r (a rank), two CPU
# devices visible and a host name of its own, so that the host rule gives
# the rank both
_CLI_CODE = f"""
import functools, socket, sys
import torch
from clustering_tpu_torch import cli
from clustering_tpu_torch.models import density
from clustering_tpu_torch.ops.engine import DensityEngine
from clustering_tpu_torch.ops.screening import ThresholdSeriesScreener
from clustering_tpu_torch.parallel import mesh as pmesh
density.DensityEngine = functools.partial(DensityEngine, row_block={RB},
                                          col_block={CB})
density.ThresholdSeriesScreener = functools.partial(
    ThresholdSeriesScreener, row_block={RB}, col_block={CB})
if len(sys.argv) > 1:
    pmesh.visible_devices = lambda device="cuda": [torch.device("cpu")] * 2
    socket.gethostname = lambda: "host" + sys.argv[1]
sys.exit(cli.main({_CLI!r}))
"""


def test_cli_two_ranks_of_two_devices_write_the_single_process_files(
        tmp_path):
    """density through the CLI's distributed switches on two CPU ranks,
    each alone on its (patched) host with two (patched) visible devices:
    the host rule meshes 4 devices, every rank writes every file of a
    single-process run, byte for byte, and its fixpoints run on the
    mesh."""
    from test_torch_parallel import _artifact_lines, _env, _wait
    coords = _coords()
    # the rendezvous store, held open here on a port the system picked;
    # both ranks join it as clients
    store = dist.TCPStore("localhost", 0, 2, is_master=True,
                          wait_for_workers=False)
    procs, dirs = [], []
    for rank in (None, 0, 1):
        wdir = tmp_path / ("single" if rank is None else f"rank{rank}")
        wdir.mkdir()
        np.savetxt(wdir / "coords.dat", coords, fmt="%.6f")
        env = _env()
        env["CLUSTERING_TORCH_DEVICE"] = "cpu"
        argv = [sys.executable, "-c", _CLI_CODE]
        if rank is not None:
            argv.append(str(rank))
            env.update({"CLUSTERING_TPU_DISTRIBUTED": "1",
                        "TORCHELASTIC_USE_AGENT_STORE": "True",
                        "CLUSTERING_TPU_COORDINATOR":
                            f"localhost:{store.port}",
                        "CLUSTERING_TPU_NUM_PROCESSES": "2",
                        "CLUSTERING_TPU_PROCESS_ID": str(rank)})
        procs.append(subprocess.Popen(
            argv, env=env, cwd=str(wdir), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
        dirs.append(wdir)
    outs = _wait(procs)
    del store
    assert "~~~ mesh of" not in outs[0][0]
    for out, _ in outs[1:]:
        assert "~~~ mesh of 4 devices: cpu, cpu" in out, out
        assert out.count("[mesh screening fixpoint") == 3
    names = sorted(f.name for f in dirs[0].iterdir())
    for must in ("pop.dat", "fe.dat", "nn.dat", "clust.0.40", "clust.0.80",
                 "clust.1.20"):
        assert must in names, names
    for wdir in dirs[1:]:
        assert sorted(f.name for f in wdir.iterdir()) == names
        for name in names:
            assert _artifact_lines(wdir / name) == _artifact_lines(
                dirs[0] / name), f"{wdir.name}: {name} differs"
