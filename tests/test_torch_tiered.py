"""The port's ub-quantile-tiered NN phase 2 against the JAX engine's.

Mirrors ``tests/test_pallas_interpret.py``'s ``test_engine_nn_tiered_phase2``
and ``test_engine_nn_auto_tier_decision``: the same data (``_bigger_blobs``,
seed 17), blocks (8, 16), band_blocks=1, the JAX engine with its Pallas
kernels in interpret mode. On both routes (bidirectional; row-side, the
JAX engine's ``NN_BIDIR_SCRATCH_CAP`` at 0) and every ``tier_qs``, the
port's ids equal the JAX engine's, its ``mode`` and ``phase2_tiles`` too,
and its distances are bit-equal to its own block-bound run. Against the
JAX engine they may differ by 2 ulps on this 3-D data: the JAX finish
recomputes d² with one rounding per product, the port with the fma chain
of its kernels (ROADMAP.md, "Distance arithmetic").
"""

import json

import numpy as np
import pytest
import torch

from clustering_tpu import ops as jops
from clustering_tpu.ops import engine as jengine
from clustering_tpu_torch.ops import engine as tengine

RB, CB = 8, 16
QS = [(0.5, 0.9, 0.99), (0.9,), (0.5, 0.99)]
ROUTES = ["bidir", "symmetric"]


def _bigger_blobs(n=600, seed=5):
    rng = np.random.default_rng(seed)
    a = rng.normal((0.0, 0.0, 0.0), 0.15, size=(n // 2, 3))
    b = rng.normal((1.5, 1.0, -0.5), 0.2, size=(n - n // 2, 3))
    return np.concatenate([a, b]).astype(np.float32)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.fixture(scope="module")
def data():
    coords = _bigger_blobs(n=700, seed=17)
    je = jengine.DensityEngine(coords, row_block=RB, col_block=CB,
                               backend="pallas")
    fe = jops.free_energies(je.populations([0.4])[0.4])
    return coords, fe


def _engines(coords, route):
    je = jengine.DensityEngine(coords, row_block=RB, col_block=CB,
                               backend="pallas")
    te = tengine.DensityEngine(coords, RB, CB, device="cpu")
    if route == "symmetric":
        je.NN_BIDIR_SCRATCH_CAP = 0
        te.NN_BIDIR = False
    return je, te


def _assert_same(te, je, got, want, block_bound):
    ts, js = te.last_stats["nn"], je.last_stats["nn"]
    assert ts["bidir"] == js["bidir"]
    for key in ("mode", "order", "band_tiles", "phase2_tiles"):
        assert ts[key] == js[key], (key, ts[key], js[key])
    for i in (0, 2):
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
        np.testing.assert_array_equal(got[i], block_bound[i])
    for i in (1, 3):
        assert _ulps(got[i], want[i]) <= 2
        np.testing.assert_array_equal(got[i].view(np.int32),
                                      block_bound[i].view(np.int32))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("qs", QS)
def test_tiered_nn_matches_jax(data, route, qs):
    coords, fe = data
    je, te = _engines(coords, route)
    block_bound = te.nearest_neighbors(fe, band_blocks=1, tier_qs=None)
    bb_tiles = te.last_stats["nn"]["phase2_tiles"]
    assert te.last_stats["nn"]["mode"] == "block-bound"
    want = je.nearest_neighbors(fe, band_blocks=1, tier_qs=qs)
    got = te.nearest_neighbors(fe, band_blocks=1, tier_qs=qs)
    assert te.last_stats["nn"]["mode"] == "tiered"
    assert te.last_stats["nn"]["route"] == route
    _assert_same(te, je, got, want, block_bound)
    # the tiers prune tiles the block bounds keep
    assert te.last_stats["nn"]["phase2_tiles"] < bb_tiles


# the auto rule's settings: (TIERED_MIN_FRAMES, TIERED_MIN_SAVED_PAIRS,
# expected mode); "reject" plans the tiers and turns them down (a saving
# requirement between the tiered list's saving and the plan's threshold)
AUTO = {"default": (None, None, "block-bound"),
        "take": (1, -1.0, "tiered"),
        "reject": (1, "between", "block-bound"),
        "never": (1, 1e30, "block-bound")}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", list(AUTO))
def test_auto_decision_matches_jax(data, monkeypatch, route, case):
    coords, fe = data
    je, te = _engines(coords, route)
    block_bound = te.nearest_neighbors(fe, band_blocks=1, tier_qs=None)
    block_tiles = te.last_stats["nn"]["phase2_tiles"]
    te.nearest_neighbors(fe, band_blocks=1, tier_qs=tengine.DensityEngine
                         .TIER_QS_DEFAULT)
    tiered_tiles = te.last_stats["nn"]["phase2_tiles"]
    frames, saved, mode = AUTO[case]
    if saved == "between":
        pairs = float(RB * CB)
        saved = (block_tiles * pairs * (1.0 - 1.0 / 3.5)
                 + (block_tiles - tiered_tiles) * pairs) / 2
        assert (block_tiles - tiered_tiles) * pairs < saved
    for cls in (jengine.DensityEngine, tengine.DensityEngine):
        if frames is not None:
            monkeypatch.setattr(cls, "TIERED_MIN_FRAMES", frames)
            monkeypatch.setattr(cls, "TIERED_MIN_SAVED_PAIRS", saved)
    want = je.nearest_neighbors(fe, band_blocks=1, tier_qs="auto")
    got = te.nearest_neighbors(fe, band_blocks=1, tier_qs="auto")
    assert je.last_stats["nn"]["mode"] == mode
    _assert_same(te, je, got, want, block_bound)


@pytest.mark.parametrize("qs", QS + [(0.25, 0.5, 0.75, 0.99)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ub_tiers_equal_jax(qs, seed):
    """The same stacked band distances (infinite bounds, pads, ties) give
    the JAX engine's taus bit for bit and its tiers."""
    rng = np.random.default_rng(seed)
    n_pad, n = 1024, 1000 - 37 * seed
    d = rng.gamma(2.0, 0.01, size=(2, n_pad)).astype(np.float32)
    d[:, ::7] = np.round(d[:, ::7], 2)  # ties
    d[1, rng.random(n_pad) < 0.1] = np.inf  # no lower-fe band neighbour
    d[:, n:] = np.inf
    tier, taus = tengine._ub_tiers(torch.from_numpy(d), n, qs)
    j_tier, j_taus = jengine._ub_tiers(d, np.int32(n), qs=qs)
    np.testing.assert_array_equal(taus.numpy().view(np.int32),
                                  np.asarray(j_taus).view(np.int32))
    np.testing.assert_array_equal(tier.numpy(), np.asarray(j_tier))
    assert (np.diff(taus.numpy()) >= 0).all()


def test_ub_tiers_all_infinite_equal_jax():
    d = np.full((2, 64), np.inf, np.float32)
    tier, taus = tengine._ub_tiers(torch.from_numpy(d), 50, (0.5, 0.9))
    j_tier, j_taus = jengine._ub_tiers(d, np.int32(50), qs=(0.5, 0.9))
    np.testing.assert_array_equal(taus.numpy(), np.asarray(j_taus))
    np.testing.assert_array_equal(tier.numpy(), np.asarray(j_tier))
    assert (tier.numpy() == 2).all()


# -- two gloo ranks ----------------------------------------------------------

_WORKER = r"""
import json, sys
import numpy as np

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
from clustering_tpu_torch.ops.density import free_energies
from clustering_tpu_torch.ops.engine import DensityEngine
from clustering_tpu_torch.parallel import mesh as pmesh

rng = np.random.default_rng(17)
n = 700
coords = np.concatenate([
    rng.normal((0.0, 0.0, 0.0), 0.15, size=(n // 2, 3)),
    rng.normal((1.5, 1.0, -0.5), 0.2, size=(n - n // 2, 3)),
]).astype(np.float32)
mesh = None
if world:
    pmesh.initialize("cpu", backend="gloo", init_method="file://" + store,
                     world_size=world, rank=rank)
    mesh = pmesh.make_mesh(devices=["cpu"])
res, stats = {}, {}
for route, on in (("bidir", True), ("symmetric", False)):
    DensityEngine.NN_BIDIR = on
    eng = DensityEngine(coords, 8, 16, device="cpu", mesh=mesh)
    fe = free_energies(eng.populations([0.4])[0.4])
    for tag, qs in (("explicit", (0.5, 0.9, 0.99)), ("auto", "auto")):
        if qs == "auto":
            DensityEngine.TIERED_MIN_FRAMES = 1
            DensityEngine.TIERED_MIN_SAVED_PAIRS = -1.0
        nn = eng.nearest_neighbors(fe, band_blocks=1, tier_qs=qs)
        for i, key in enumerate(("nh", "nhd", "hd", "hdd")):
            res[f"{route}/{tag}/{key}"] = nn[i]
        stats[f"{route}/{tag}"] = {
            k: v for k, v in eng.last_stats["nn"].items()
            if not k.startswith("t_")}
np.savez(out, stats=json.dumps(stats), **res)
if world:
    import torch.distributed
    torch.distributed.destroy_process_group()
"""


def test_tiered_on_two_gloo_ranks_matches_one_rank(tmp_path):
    """The bidirectional tiered list dealt over two ranks and merged by
    MIN gives the single rank's results bit for bit, explicit and auto;
    the row-side route stays block-bound on a mesh, as the JAX engine's
    row-only tiered plan is single-device."""
    import subprocess
    import sys

    from test_torch_parallel import _env, _wait
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    runs = {}
    for world in (0, 2):
        outs = [tmp_path / f"r{world}_{r}.npz" for r in range(max(world, 1))]
        _wait([subprocess.Popen(
            [sys.executable, str(worker), str(r), str(world),
             str(tmp_path / f"store{world}"), str(out)], env=_env(),
            cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for r, out in enumerate(outs)])
        runs[world] = []
        for out in outs:
            with np.load(out) as f:
                got = {k: f[k] for k in f.files if k != "stats"}
                got["stats"] = json.loads(str(f["stats"]))
            runs[world].append(got)
    one = runs[0][0]
    for key, st in one["stats"].items():
        assert st["mode"] == "tiered", key
    for rank, got in enumerate(runs[2]):
        for key, want in one.items():
            if key == "stats":
                continue
            # bit for bit (the row-side route, block-bound on the mesh,
            # finds the same neighbours)
            bits = np.int32 if want.dtype.kind == "f" else want.dtype
            np.testing.assert_array_equal(got[key].view(bits),
                                          want.view(bits),
                                          err_msg=f"rank {rank} {key}")
        for tag in ("explicit", "auto"):
            st = got["stats"][f"bidir/{tag}"]
            assert st["mode"] == "tiered" and st["route"] == "bidir-mesh"
            assert st["phase2_tiles"] == one["stats"][f"bidir/{tag}"][
                "phase2_tiles"]
            shares = [r["stats"][f"bidir/{tag}"]["per_device_tiles"]["phase2"]
                      for r in runs[2]]
            assert sum(shares) == st["phase2_tiles"]
            assert max(shares) - min(shares) <= 1
            assert got["stats"][f"symmetric/{tag}"]["mode"] == "block-bound"


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_tiered_on_the_card_equals_block_bound(route):
    """At 2^16 frames and the default blocks, on the card: explicit tiers
    (the kernels on a tiered list), after a band prefetch, give the
    block-bound run's neighbours bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from clustering_tpu_torch.ops.density import free_energies
    coords = _bigger_blobs(n=1 << 16, seed=3)
    eng = tengine.DensityEngine(coords, device="cuda")
    eng.NN_BIDIR = route == "bidir"
    fe = free_energies(eng.populations([0.05], nn_band_radius=0.05)[0.05])
    got = eng.nearest_neighbors(fe, tier_qs=eng.TIER_QS_DEFAULT)
    st = eng.last_stats["nn"]
    assert st["mode"] == "tiered" and st["band_prefetched"]
    want = eng.nearest_neighbors(fe, tier_qs=None)
    assert eng.last_stats["nn"]["mode"] == "block-bound"
    for a, b in zip(got, want):
        bits = np.int32 if b.dtype.kind == "f" else b.dtype
        np.testing.assert_array_equal(a.view(bits), b.view(bits))
