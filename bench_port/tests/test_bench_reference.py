"""The plain reference against brute force at tiny N."""

import numpy as np
import pytest
import torch

from bench_port import fel
from bench_port.checks import density
from bench_port.entries import cli
from bench_port.reference import density as rd, merge


def frames(n, seed):
    return fel.coords_f32(fel.micro_units(fel.synthetic_fel(n, 4, seed)))


def fma_chain(a, b):
    """float32 fma chain through torch.addcmul on this CPU."""
    acc = torch.zeros(len(a), len(b))
    for k in range(a.shape[1]):
        d = a[:, k, None] - b[None, :, k]
        acc = torch.addcmul(acc, d, d)
    return acc


def test_sq_dists_is_the_fma_chain():
    x = torch.as_tensor(frames(2000, 3))
    got = rd.sq_dists(x[:64], x)
    assert torch.equal(got, fma_chain(x[:64], x))
    assert torch.equal(rd.pair_sq_dists(x, torch.arange(64),
                                        torch.arange(64, 128)),
                       got[torch.arange(64), torch.arange(64, 128)])
    # the plain sum of squares differs on some pairs: the chain matters
    plain = ((x[:64, None, :] - x[None, :, :]) ** 2).sum(-1)
    assert (plain != got).any()


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_sweep_against_brute_force(seed):
    n = 1500
    x = frames(n, seed)
    x[7] = x[3]  # a duplicate frame: d2 = 0 is no neighbour
    xt = torch.as_tensor(x)
    d2 = fma_chain(xt, xt).numpy()
    r2 = rd.radius2(0.1)
    pops = (d2 <= r2).sum(1)
    rows = np.asarray([0, 3, 7, 11, int(np.argmax(pops)), 1499])
    got = rd.sweep(xt, torch.as_tensor(rows), 0.1, torch.as_tensor(pops),
                   row_block=4, col_block=256)
    assert np.array_equal(got["pop"], pops[rows])
    assert np.array_equal(
        rd.populations(xt, torch.as_tensor(rows), 0.1, row_block=4,
                       col_block=256), pops[rows])
    for r, i in enumerate(rows):
        pos = np.where(d2[i] > 0, d2[i], np.inf)
        assert got["nh_d2"][r] == pos.min()
        assert got["nh_id"][r] == np.flatnonzero(pos == pos.min())[0]
        hd = np.where(pops > pops[i], pos, np.inf)
        assert got["hd_d2"][r] == hd.min()
        if np.isfinite(hd.min()):
            assert got["hd_id"][r] == np.flatnonzero(hd == hd.min())[0]


def test_populations_on_the_radius():
    """Pairs that the float32 chain puts on either side of r^2, against
    the float64 sum, are counted by the chain."""
    x = torch.as_tensor(frames(3000, 6))
    r2 = rd.radius2(0.1)
    rows = torch.arange(0, 3000, 5)
    # frames 1..2000 on the radius of frame 0, in random directions
    rng = np.random.default_rng(6)
    way = rng.normal(size=(2000, 4))
    way /= np.linalg.norm(way, axis=1, keepdims=True)
    reach = 0.1 * (1 + rng.uniform(-1e-6, 1e-6, size=(2000, 1)))
    y = x.clone()
    y[1:2001] = (x[0].double() + torch.as_tensor(way * reach)).float()
    d2 = fma_chain(y, y)
    exact = ((y[:, None, :].double() - y[None, :, :].double()) ** 2).sum(-1)
    near = ((exact - r2).abs() < 1e-6 * r2).sum()
    assert near > 10
    assert ((d2 <= r2) != (exact <= r2)).any()
    assert np.array_equal(rd.populations(y, rows, 0.1, col_block=1000),
                          (d2[rows] <= r2).sum(1).numpy())


def components_brute(d2, frames, link2):
    """Each of ``frames``' smallest frame of its component of d2 < link2,
    by a flood fill over the dense matrix."""
    lab = {}
    for f in frames:
        if f in lab:
            continue
        todo, comp = [f], {f}
        while todo:
            i = todo.pop()
            for j in frames[d2[i, frames] < link2]:
                if j not in comp:
                    comp.add(j)
                    todo.append(j)
        for j in comp:
            lab[j] = min(comp)
    return np.asarray([lab[f] for f in frames])


@pytest.mark.parametrize("link2,chunk", [(0.002, 1 << 20), (0.004, 500)])
def test_clusterings_against_brute_force(link2, chunk):
    n = 1500
    x = torch.as_tensor(frames(n, 8))
    x[9] = x[4]  # a duplicate frame: d2 = 0 joins
    d2 = ((x[:, None, :].double() - x[None, :, :].double()) ** 2).sum(-1)
    d2 = d2.numpy()
    levels = np.random.default_rng(3).integers(0, 4, n)
    levels[[4, 9]] = 0
    slack = 0.05
    got = merge.clusterings(x, torch.as_tensor(levels), 3, link2, slack,
                            chunk)
    for k, (sure, maybe) in enumerate(got):
        frames_k = np.flatnonzero(levels <= k)
        assert np.array_equal(
            sure.numpy()[frames_k],
            components_brute(d2, frames_k, link2 * (1 - slack)))
        assert np.array_equal(
            maybe.numpy()[frames_k],
            components_brute(d2, frames_k, link2 * (1 + slack)))
        out = np.flatnonzero(levels > k)
        assert np.array_equal(sure.numpy()[out], out)
    assert got[0][0][9] == 4


def test_merge_numbers():
    sure = torch.as_tensor([0, 0, 2, 3, 3, 5])
    maybe = torch.as_tensor([0, 0, 2, 2, 2, 5])
    comps = [(sure, maybe)]
    right = np.asarray([1, 1, 2, 2, 2, 3])
    assert density.merge_numbers([right], comps) == (0, 0)
    also = np.asarray([1, 1, 2, 3, 3, 4])  # the unsure edge left out
    assert density.merge_numbers([also], comps) == (0, 0)
    split = np.asarray([1, 2, 3, 4, 4, 5])
    assert density.merge_numbers([split], comps) == (1, 0)
    joined = np.asarray([1, 1, 1, 1, 1, 1])
    assert density.merge_numbers([joined], comps) == (0, 2)
    unclustered = np.asarray([0, 0, 1, 1, 1, 0])
    assert density.merge_numbers([unclustered], comps) == (0, 0)
    assert density.levels([np.asarray([0, 1, 0]),
                         np.asarray([1, 1, 0])]).tolist() == [1, 0, 2]


def test_control_differs():
    x = torch.as_tensor(frames(2000, 4))
    got = rd.sweep(x, torch.arange(0, 2000, 10), 0.1,
                   torch.zeros(2000, dtype=torch.int64), control=True)
    assert (got["control"]["pop"] != got["pop"]).sum() > 10


def test_threshold_series():
    assert [float(t) for t in cli.threshold_series(0.5, 0.5, 2.0)] == [
        0.5, 1.0, 1.5, 2.0]
    assert len(cli.threshold_series(0.2, 0.2, 4.0)) == 20


def test_text_round_trip():
    q = fel.micro_units(fel.synthetic_fel(5000, 4, 9))
    text = fel.format_rows(q)
    back = np.asarray(text.split(), dtype=np.float64).reshape(q.shape)
    assert np.array_equal(back.astype(np.float32), fel.coords_f32(q))
    import io
    buf = io.BytesIO()
    np.savetxt(buf, q / 1e6, fmt="%.6f")
    assert buf.getvalue() == text


def test_equal_occupancy():
    for seed in (11, 12):
        which = fel.basin_walk(40001, 4, np.random.default_rng(seed))
        assert np.bincount(which).tolist() == [10001, 10000, 10000, 10000]
        # stays, not frames, are shuffled: the walk is sticky
        assert (np.diff(which) != 0).sum() < 200
    x = fel.synthetic_fel(4001, 4, 11)
    assert np.array_equal(x, fel.synthetic_fel(4001, 4, 11))
    assert not np.array_equal(x, fel.synthetic_fel(4001, 4, 12))
