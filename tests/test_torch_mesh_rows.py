"""The row-dealt mesh: each device plans and sweeps only the row blocks
dealt to it (device g of S owns blocks g, g + S, ...), against the
engines on one device and against the benchmark's plain references.

Local meshes of ``["cpu"] * 3`` and ``["cpu"] * 4`` over 9,990 frames of
the benchmark's landscape with blocks (16, 32): 626 row blocks, which
neither 3 nor 4 divides, so the deals are uneven. On both sweep routes
(the engines' bidirectional switches on, then off) every kernel call of
one device has its counterpart on the mesh in S calls, one per device,
whose tile lists are disjoint, hold only their device's row blocks, and
together are the one-device list; no block-pair matrix that a planner
allocates on the mesh has more than ceil(626 / S) rows. Populations at
one radius (``-r``) and at three (``-R``), both neighbour pairs (phase
2 tiered on the bidirectional route) and the clusterings of ``-T 0.5 0.5
2.0`` are the one device's bit for bit, and the mesh's outputs read within every
limit of the benchmark's ``density`` comparison against its plain
references (``bench_port/reference/density.py`` and ``merge.py``).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_port import fel, spec as specs
from bench_port.checks import density as judge
from bench_port.entries import cli as cli_entry
from bench_port.reference import density as ref_density
from clustering_tpu_torch.ops import kernels, pruning
from clustering_tpu_torch.ops.density import free_energies
from clustering_tpu_torch.ops.engine import DensityEngine
from clustering_tpu_torch.ops.neighbors import compute_sigma2
from clustering_tpu_torch.ops.screening import (ScreeningEngine,
                                                ThresholdSeriesScreener)
from clustering_tpu_torch.parallel import make_mesh

N, RB, CB = 9990, 16, 32
NRB = 626
SEED = 2147493331
RADIUS = 0.1
SCAN = (0.05, 0.1, 0.15)
THRESHOLDS = cli_entry.threshold_series(0.5, 0.5, 2.0)
SIZES = (3, 4)
ROUTES = ("bidir", "symmetric")
# each kernel wrapper the engines call, and the positions of its ti, tj
LISTS = {"pops_bidir": 3, "pops_sparse": 4, "nn_bidir": 4, "nn_sparse": 7,
         "label_min_bidir": 4, "label_min_sparse": 5}


def _coords():
    q = fel.micro_units(fel.synthetic_fel(N, 4, fel.seed_words(SEED)))
    return fel.coords_f32(q)


def _switches(mp, route):
    on = route == "bidir"
    mp.setattr(DensityEngine, "POPS_BIDIR", on)
    mp.setattr(DensityEngine, "NN_BIDIR", on)
    mp.setattr(ScreeningEngine, "BIDIR", on)


def _run(mesh, mp, route):
    """Every stage on ``mesh`` (None: one device): (outputs, the kernel
    calls' (name, ti, tj), the rows of every block-pair matrix that a
    planner allocated). Phase 2 is tiered on the bidirectional route and
    block-bound on the row-side one, which keeps it so on a mesh (the JAX
    engine's rule)."""
    calls, rows = [], []
    for name, at in LISTS.items():
        fn = getattr(kernels, name)

        def call(*args, _fn=fn, _name=name, _at=at):
            calls.append((_name, args[_at].clone(), args[_at + 1].clone()))
            return _fn(*args)
        mp.setattr(kernels, name, call)
    real = pruning._allocated

    def allocated(matrix):
        rows.append(matrix.shape[-2])
        return real(matrix)
    mp.setattr(pruning, "_allocated", allocated)
    coords = _coords()
    eng = DensityEngine(coords, RB, CB, device="cpu", mesh=mesh)
    assert eng.n_pad // RB == NRB
    out = {"pops": eng.populations([RADIUS])[RADIUS]}
    scan = eng.populations(list(SCAN))
    out.update({f"scan{r}": scan[r] for r in SCAN})
    fe = free_energies(out["pops"])
    nn = eng.nearest_neighbors(
        fe, tier_qs=(0.5, 0.9, 0.99) if route == "bidir" else None)
    out.update(zip(("nh_id", "nh_d2", "hd_id", "hd_d2"), nn))
    md2 = np.float32(4.0 * compute_sigma2(out["nh_d2"]))
    series = ThresholdSeriesScreener(coords, fe, THRESHOLDS, RB, CB,
                                     device="cpu", mesh=mesh,
                                     hd_neighbors=(out["hd_id"],
                                                   out["hd_d2"]))
    prev = None
    for k in range(len(THRESHOLDS)):
        prev = series.step(prev, k, md2)
        out[f"clust{k}"] = prev
    return out, calls, rows


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(route, k):
        if (route, k) not in cache:
            # one thread: the test workers share the machine's cores
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                with pytest.MonkeyPatch.context() as mp:
                    _switches(mp, route)
                    mesh = make_mesh(devices=["cpu"] * k) if k else None
                    cache[route, k] = _run(mesh, mp, route)
            finally:
                torch.set_num_threads(threads)
        return cache[route, k]
    return get


def _tiles(ti, tj):
    return set(zip(ti.tolist(), tj.tolist()))


@pytest.mark.parametrize("k", SIZES)
@pytest.mark.parametrize("route", ROUTES)
def test_deals_partition_the_one_device_plan(route, k, runs):
    """Each kernel call of one device is k calls on the mesh, in deal
    order: disjoint lists of the dealt row blocks whose union is the
    one-device list, each row-major sorted; every block-pair matrix
    (bounds, planes, masks, closures) that a planner allocates has at
    most ceil(nrb / k) rows on the mesh, and nrb on one device; the
    outputs are the one device's bit for bit."""
    one, one_calls, one_rows = runs(route, 0)
    got, calls, rows = runs(route, k)
    assert len(calls) == k * len(one_calls) and one_calls
    for i, (name, ti, tj) in enumerate(one_calls):
        group = calls[k * i:k * i + k]
        assert {g[0] for g in group} == {name}
        union = set()
        for g, (_, gi, gj) in enumerate(group):
            assert (gi.long() % k == g).all(), (name, g)
            key = gi.long() * (NRB * 2) + gj.long()
            assert (key[1:] > key[:-1]).all(), (name, g)
            mine = _tiles(gi, gj)
            assert not union & mine, (name, g)
            union |= mine
        assert union == _tiles(ti, tj), (name, i)
    assert set(one_rows) == {NRB}
    assert rows and max(rows) == -(-NRB // k)
    assert sorted(got) == sorted(one)
    for key, want in one.items():
        assert got[key].dtype == want.dtype, key
        bits = np.int32 if want.dtype.kind == "f" else want.dtype
        np.testing.assert_array_equal(got[key].view(bits), want.view(bits),
                                      err_msg=f"{route} k={k} {key}")
    assert len(np.unique(got[f"clust{len(THRESHOLDS) - 1}"])) > 2


@pytest.mark.parametrize("k", SIZES)
def test_mesh_outputs_pass_the_benchmark_comparison(k, runs):
    """The mesh's outputs against the plain references under the
    ``density`` comparison's rules and the limits of the cell's traffic:
    the populations, free energies, both neighbours at a seeded sample
    and the clusterings of every frame; the ``-R`` populations at the
    sample, exact, at each radius."""
    got, _, _ = runs("bidir", k)
    coords = _coords()
    run = SimpleNamespace(device="cpu", seed=SEED, coords=coords,
                          config={"reference": "density", "radius": RADIUS,
                                  "sample_frames": 256})
    out = dict(got, fe=free_energies(got["pops"]),
               clust=[got[f"clust{i}"] for i in range(len(THRESHOLDS))])
    ref = judge.Reference(run, out)
    numbers = judge.compare(out, ref, THRESHOLDS)
    limits = specs.traffic("cli-t4")["limits"]
    for name, value in numbers.items():
        assert value <= limits[name], (name, value)
    rows = torch.as_tensor(ref.rows)
    for r in SCAN:
        want = ref_density.populations(torch.as_tensor(coords), rows, r)
        np.testing.assert_array_equal(got[f"scan{r}"][ref.rows],
                                      want, err_msg=str(r))
