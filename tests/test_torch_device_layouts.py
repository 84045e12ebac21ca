"""The density engine's layouts built on its device: each frame order
(``pruning.dim0_order_device``, ``pruning.morton_order_device``) equal
element for element to the host references (``np.argsort(kind="stable")``
of the first coordinate, ``pruning.morton_order``), the (D, N_pad) frame
matrix equal to the padded transpose of the sorted frames with pads at
3e38, the original ids with pads at IMAX, and the host order an int64
array. The inputs hold tied rows, a first coordinate of mixed -0.0 and
+0.0, or a constant coordinate (a span of 0), at N = 1 to 30000, one N no
multiple of the blocks, and D = 1 to 6; the build never sorts on the host
and keeps neither the upload nor the keys."""

import numpy as np
import pytest
import torch

from clustering_tpu_torch.ops import engine as tengine
from clustering_tpu_torch.ops import kernels, pruning

RB, CB = 8, 16
NAMES = ("orig", "dim0", "morton")


def _coords(n, d, kind, seed=0):
    """(n, d) float32 frames: normal, then ``kind``: "ties" (every fifth
    row a copy of row 1), "zeros" (a first coordinate of which about half
    is -0.0 or +0.0) or "constant" (the last coordinate 2.5)."""
    rng = np.random.default_rng(seed + 1000 * n + d)
    c = rng.normal(size=(n, d)).astype(np.float32)
    if kind == "ties":
        c[::5] = c[min(1, n - 1)]
    elif kind == "zeros":
        zero = rng.random(n) < 0.5
        sign = rng.choice(np.float32([-1.0, 1.0]), n)
        c[:, 0] = np.where(zero, np.float32(0.0) * sign, c[:, 0])
    else:
        c[:, -1] = np.float32(2.5)
    return c


def _reference(coords, name):
    """The host order of layout ``name``, as the engine built it on the
    host before."""
    if name == "orig":
        return np.arange(len(coords))
    if name == "dim0":
        return np.argsort(coords[:, 0], kind="stable")
    return pruning.morton_order(coords)


def _assert_layout(eng, coords, name):
    order = eng.layout_order(name)
    assert isinstance(order, np.ndarray) and order.dtype == np.int64
    np.testing.assert_array_equal(order, _reference(coords, name))
    padded = np.full((eng.n_pad, eng.d), np.float32(3e38), dtype=np.float32)
    padded[:eng.n] = coords[order]
    coords_t = eng.coords_t(name).cpu().numpy()
    assert coords_t.dtype == np.float32 and coords_t.flags.c_contiguous
    np.testing.assert_array_equal(coords_t, padded.T)
    oid = np.full(eng.n_pad, kernels.IMAX, dtype=np.int32)
    oid[:eng.n] = order
    got = eng.oid(name).cpu().numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, oid)


@pytest.mark.parametrize("kind", ["ties", "zeros", "constant"])
@pytest.mark.parametrize("n", [1, 9, 1237, 2048, 30000])
@pytest.mark.parametrize("d", [1, 2, 4, 6])
def test_engine_layouts_equal_the_host_sorts(d, n, kind, monkeypatch):
    coords = _coords(n, d, kind)
    eng = tengine.DensityEngine(coords, RB, CB, device="cpu")
    assert all(eng.layout_order(name) is None for name in NAMES)
    # the engine neither sorts on the host nor calls the Morton references
    for mod, fn in ((tengine.np, "argsort"),
                    (tengine.textio_native, "morton_order_pad"),
                    (pruning, "morton_order")):
        monkeypatch.setattr(mod, fn, None)
    eng._best_sort(np.float32(0.01))
    eng._layout("orig")
    monkeypatch.undo()
    # each layout's matrix is all the engine keeps of the build (besides
    # the bbox matrices that chose between dim0 and morton); the ids come
    # at first use
    assert set(eng._dev) == {("ct", name) for name in NAMES} | {
        ("d2b", "dim0"), ("d2b", "morton")}
    for name in NAMES:
        _assert_layout(eng, coords, name)


@pytest.mark.parametrize("d", [31, 32, 63, 64, 70])
def test_morton_order_device_at_wide_d(d):
    """From D = 32 the reference's numpy path runs (the native pass takes
    D <= 31); from D = 63 a bit of a coordinate lands on 2^62 and 2^63,
    and from D = 65 beyond the key, which numpy's uint64 shifts drop."""
    coords = _coords(3001, d, "ties")
    coords[::7, -1] = coords[:, -1].max()  # the top bit of the last column
    np.testing.assert_array_equal(
        pruning.morton_order_device(torch.from_numpy(coords)).numpy(),
        pruning.morton_order(coords))


@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 9])
def test_morton_order_device_at_full_scale(d):
    """Coordinates that reach both ends of the quantised range in every
    byte of the key (62 bits at D = 1, where the scale 2^62 - 1 rounds up
    in float64 and the top coordinate quantises to 2^62), with distinct
    keys: the device keys sort as the reference's."""
    rng = np.random.default_rng(d)
    coords = rng.uniform(-1.0, 1.0, size=(4099, d)).astype(np.float32)
    coords[0], coords[1] = -1.0, 1.0
    coords[2:40] = np.float32(1.0) - np.float32(2.0 ** -24) * np.arange(
        1, 39, dtype=np.float32)[:, None]
    np.testing.assert_array_equal(
        pruning.morton_order_device(torch.from_numpy(coords)).numpy(),
        pruning.morton_order(coords))


def test_populations_reads_the_device_layouts():
    """The populations' host finish and the NN search take the downloaded
    orders: both equal the engine's dense plain versions."""
    coords = _coords(2048, 3, "ties", seed=5)
    eng = tengine.DensityEngine(coords, RB, CB, device="cpu")
    pops = eng.populations([0.3])[0.3]
    diff = coords[:, None, :] - coords[None, :, :]
    d2 = (diff * diff).sum(axis=2)
    np.testing.assert_array_equal(
        pops, (d2 <= np.float32(0.3) * np.float32(0.3)).sum(axis=1))
    order = eng.layout_order(eng.last_stats["populations"]["order"])
    np.testing.assert_array_equal(
        order, _reference(coords, eng.last_stats["populations"]["order"]))


# -- on the card ---------------------------------------------------------------

N_CARD = 10 ** 6
# the build's transient above what it keeps: the upload (16 B a frame at
# D = 4), the sort's keys, indices and buffers (<= 40 B a frame) and one
# chunk of the Morton keys (16 MiB)
CARD_TRANSIENT_BYTES_PER_FRAME = 64
CARD_TRANSIENT_FIXED = 32 << 20


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ties", "zeros", "constant"])
def test_cuda_layouts_equal_the_host_sorts(kind):
    """At 10^6 frames on the card: the orders, matrices and ids equal the
    host references, each sort span counts ``on_device`` 1, and the
    build's peak lies within a stated bound of what it keeps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from clustering_tpu_torch.utils import timer
    coords = _coords(N_CARD, 4, kind, seed=7)
    eng = tengine.DensityEngine(coords, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    timer.reset()
    eng._build_layouts(("dim0", "morton"))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    kept = torch.cuda.memory_allocated() - base
    sorts = [s.as_dict() for s in timer.finished()
             if s.name.startswith("layout.sort.")]
    assert sorted(s["name"] for s in sorts) == ["layout.sort.dim0",
                                                "layout.sort.morton"]
    assert all(s["counters"]["on_device"] == 1 for s in sorts)
    for name in ("dim0", "morton"):
        _assert_layout(eng, coords, name)
    assert peak - kept <= (CARD_TRANSIENT_BYTES_PER_FRAME * N_CARD
                           + CARD_TRANSIENT_FIXED), (peak, kept)
