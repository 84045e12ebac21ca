"""The radius scan (``density -R r1 ... rk``) of the port against the
benchmark's plain reference ``bench_port.reference.scan``: the engine's
populations at the 8 radii of the ``cli-10m-scan8`` cell and at 10 (two
launch groups of the counting kernel) on both routes, the CLI's 16
files, the spans and counters that the scan adds to the ``-v`` log, and
on the card ``kernels.pops_bidir`` at 8 and 10 radii against its plain
version, and the warp's skip of the radii that a step does not reach: at
2, 4, 8 and 10 radii out of order and with masks that turn off radii
that do hold pairs, counts exact, and its step counters exact where every
or no step reaches a radius."""

import contextlib
import functools
import io
import json

import numpy as np
import pytest
import torch

from bench_port import fel
from bench_port.reference import scan as ref_scan
from clustering_tpu_torch import cli as tcli
from clustering_tpu_torch.models import density as tdensity
from clustering_tpu_torch.ops import engine as tengine
from clustering_tpu_torch.ops import kernels
from clustering_tpu_torch.utils import timer

N, D = 3000, 4
# blocks small enough that many tiles admit some radii and not others
RB, CB = 16, 256
RADII8 = [0.05, 0.075, 0.1, 0.125, 0.15, 0.175, 0.2, 0.25]
RADII10 = RADII8 + [0.3, 0.35]
ROUTES = {"bidir": True, "symmetric": False}


@pytest.fixture(scope="module")
def coords():
    return fel.coords_f32(fel.micro_units(fel.synthetic_fel(N, D, 20)))


@functools.lru_cache(maxsize=None)
def _want(radii):
    x = fel.coords_f32(fel.micro_units(fel.synthetic_fel(N, D, 20)))
    return ref_scan.populations(torch.as_tensor(x), torch.arange(N),
                                list(radii))


def _popcount(rmask):
    return sum(bin(int(m)).count("1") for m in np.asarray(rmask))


@pytest.mark.parametrize("radii", [RADII8, RADII10], ids=["r8", "r10"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_engine_scan_equals_reference(coords, monkeypatch, route, radii):
    """Every frame's population at every radius, exact; the plan's masks
    are partial on some tiles, and ``mask_bits`` is their popcount."""
    monkeypatch.setattr(tengine.DensityEngine, "POPS_BIDIR", ROUTES[route])
    eng = tengine.DensityEngine(coords, RB, CB, device="cpu")
    got = eng.populations(radii)
    stats = eng.last_stats["populations"]
    assert stats["mode"] == route
    want = _want(tuple(radii))
    for k, r in enumerate(radii):
        assert np.array_equal(got[r], want[k]), r
    _, _, _, rmask = eng.pops_plan(radii, ROUTES[route])
    full = (1 << len(radii)) - 1
    rm = rmask.numpy()
    assert ((rm != 0) & (rm != full)).any() and (rm == full).any()
    assert stats["mask_bits"] == _popcount(rm)


def _run_cli(workdir, coords, monkeypatch):
    """``density -R <8 radii> -p pop -d fe -v`` in this process, blocks
    (RB, CB), the ``[spans]`` line on; (its log, the masks of its
    plan)."""
    plans = []
    real_plan = tengine.DensityEngine._pops_plans

    def pops_plans(self, *args, **kwargs):
        out = real_plan(self, *args, **kwargs)
        (deal,) = out[1]  # one device: one deal, every row
        plans.append(deal[2].clone())
        return out

    monkeypatch.chdir(workdir)
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    monkeypatch.setenv(tcli.SUBSTAGES_ENV, "1")
    monkeypatch.setattr(tdensity, "DensityEngine", functools.partial(
        tengine.DensityEngine, row_block=RB, col_block=CB))
    monkeypatch.setattr(tengine.DensityEngine, "_pops_plans", pops_plans)
    np.savetxt("coords.dat", coords, fmt="%.6f")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli.main(["density", "-f", "coords.dat", "-R"]
                         + [str(r) for r in RADII8]
                         + ["-p", "pop", "-d", "fe", "-v"]) == 0
    return out.getvalue(), plans


def test_cli_scan_files_and_spans(coords, tmp_path, monkeypatch):
    log, plans = _run_cli(tmp_path, coords, monkeypatch)
    want = _want(tuple(RADII8))
    for k, r in enumerate(RADII8):
        pops = np.loadtxt(tmp_path / f"pop_{r:f}", comments="#")
        fe = np.loadtxt(tmp_path / f"fe_{r:f}", comments="#")
        assert np.array_equal(pops.astype(np.int64), want[k]), r
        assert np.max(np.abs(fe + np.log(pops / pops.max()))) < 1e-5, r
    assert len(list(tmp_path.glob("pop_*"))) == 8
    assert len(list(tmp_path.glob("fe_*"))) == 8
    line = [ln for ln in log.splitlines() if ln.startswith("[spans] ")][-1]
    spans = [s for s in json.loads(line[len("[spans] "):])["spans"]
             if s["thread"] == "MainThread"]
    names = {s["id"]: s["name"] for s in spans}

    def one(name):
        found = [s for s in spans if s["name"] == name]
        assert len(found) == 1, name
        return found[0]

    masks = one("populations.radius_masks")
    assert names[masks["parent"]] == "populations.plan"
    assert masks["counters"]["radii"] == 8
    assert len(plans) == 1
    assert masks["counters"]["mask_bits"] == _popcount(plans[0]) > 0
    assert one("populations.sweep")["counters"]["radii"] == 8
    fes = one("density.free_energies")
    assert fes["parent"] is None and fes["counters"]["radii"] == 8


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n_radii", [8, 10])
def test_cuda_pops_bidir_scan_radii_match_plain(coords, n_radii):
    """``kernels.pops_bidir`` with the scan's radii (10: two launches) on
    the engine's own plan, whose masks are partial: counts exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    radii = RADII10[:n_radii]
    eng = tengine.DensityEngine(coords, RB, CB, device="cuda")
    name, ti, tj, rmask = eng.pops_plan(radii)
    full = (1 << n_radii) - 1
    assert bool(((rmask != 0) & (rmask != full)).any())
    r2 = torch.tensor([np.float32(r) * np.float32(r) for r in radii],
                      device="cuda")
    args = (eng.coords_t(name), r2, N, ti, tj, rmask, RB, CB)
    kernels.reset_launches()
    got = kernels.pops_bidir(*args)
    assert torch.equal(got, kernels.pops_bidir_plain(*args))
    assert kernels.LAUNCHES["pops_bidir"] == -(-n_radii // 8)


def _counted(args):
    """``kernels.pops_bidir(*args)`` inside a span: (counts, the span's
    settled counters)."""
    with timer.span("sweep") as sweep:
        got = kernels.pops_bidir(*args)
    sweep.settle()
    return got, sweep.counters


@pytest.mark.cuda
@pytest.mark.parametrize("n_radii", [2, 4, 8, 10])
def test_cuda_pops_bidir_skip_matches_plain(coords, n_radii):
    """The skip of the radii that a warp's step does not reach, on the
    scan's frames: radii out of order, the plan's partial masks with one
    more bit cleared on tiles that hold pairs within that radius (they
    count 0 there): counts exact; fewer radius bodies run than steps
    times radii."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    order = [9, 1, 5, 0, 7, 3, 8, 2, 6, 4]
    radii = [RADII10[k] for k in order if k < n_radii]
    eng = tengine.DensityEngine(coords, RB, CB, device="cuda")
    name, ti, tj, rmask = eng.pops_plan(radii)
    # the largest radius's bit off on every third tile that holds it
    big = 1 << radii.index(max(radii))
    cut = rmask.clone()
    sel = ((cut & big) != 0) & (torch.arange(len(cut), device="cuda") % 3
                                == 0)
    cut[sel] &= ~big
    r2 = torch.tensor([np.float32(r) * np.float32(r) for r in radii],
                      device="cuda")
    args = (eng.coords_t(name), r2, N, ti, tj, cut, RB, CB)
    got, counters = _counted(args)
    assert torch.equal(got, kernels.pops_bidir_plain(*args))
    full = kernels.pops_bidir_plain(eng.coords_t(name), r2, N, ti, tj,
                                    rmask, RB, CB)
    k = radii.index(max(radii))
    assert int(full[k].sum()) > int(got[k].sum())
    steps, bodies = (counters["pops_bidir.warp_steps"],
                     counters["pops_bidir.radius_steps"])
    assert 0 < bodies < n_radii * steps


@pytest.mark.cuda
@pytest.mark.parametrize("rb,cb", [(16, 256), (128, 512)])
@pytest.mark.parametrize("n_radii", [1, 2, 4, 8, 10])
def test_cuda_pops_bidir_step_counts(rb, cb, n_radii):
    """Distinct frames, every upper tile, every radius on: radii below
    every distance run no radius body; radii above every distance run
    each radius in every step (every step here holds a strictly-upper
    pair); one radius counts nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 2048
    x = torch.as_tensor(np.random.default_rng(n_radii).normal(
        0.0, 1.0, size=(n, D)).astype(np.float32))
    d2 = torch.cdist(x.double(), x.double()) ** 2
    d2.fill_diagonal_(float("inf"))
    least = float(d2.min())
    assert least > 0  # no two frames equal
    ct = x.T.contiguous().cuda()
    nrb, ncb = n // rb, n // cb
    ti, tj = torch.nonzero(
        (torch.arange(ncb)[None, :] + 1) * cb - 1
        > torch.arange(nrb)[:, None] * rb, as_tuple=True)
    ti, tj = (t.to(torch.int32).cuda() for t in (ti, tj))
    rmask = torch.full_like(ti, (1 << n_radii) - 1)
    launches = -(-n_radii // 8)
    for scale, want in ((least / 4, 0), (1e6, n_radii)):
        r2 = torch.linspace(scale, scale / 2, n_radii,
                            dtype=torch.float32).cuda()
        args = (ct, r2, n, ti, tj, rmask, rb, cb)
        got, counters = _counted(args)
        assert torch.equal(got, kernels.pops_bidir_plain(*args))
        if n_radii == 1:
            assert "pops_bidir.warp_steps" not in counters
            continue
        steps = counters["pops_bidir.warp_steps"]
        assert steps > 0 and steps % launches == 0
        assert counters["pops_bidir.radius_steps"] \
            == want * steps // launches
