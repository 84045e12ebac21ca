"""The port's ``models.density.screening_step`` against the JAX package's.

The JAX function runs on a ``backend="pallas"`` ``ScreeningEngine`` in
interpret mode, whose distance arithmetic is the port's fma chain
(ROADMAP.md C.5), so the two must agree exactly, cluster names included:
over a series of thresholds with ``order``, ``coords_sorted`` and the
engine reused, with ``incremental`` off and on, from no previous
clustering and from a seeded one, through the early return of a
threshold with nothing new below it. The series from no previous
clustering must also equal the port's ``ThresholdSeriesScreener.step``
series.
"""

import numpy as np
import pytest

from clustering_tpu.models import density as jdensity
from clustering_tpu.ops import screening as jscreening
from clustering_tpu_torch.models import density as tdensity
from clustering_tpu_torch.ops import screening as tscreening
from clustering_tpu_torch.ops.density import free_energies, populations
from clustering_tpu_torch.ops.neighbors import (compute_sigma2,
                                                nearest_neighbors)

RB, CB = 8, 16
# strictly ascending, as a -T series; the early return gets its own step
THRESHOLDS = (0.5, 1.0, 1.5, 2.5)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(17)
    coords = np.concatenate([
        rng.normal((0.0, 0.0), 0.15, size=(130, 2)),
        rng.normal((1.5, 0.4), 0.2, size=(100, 2)),
        rng.normal((0.6, 1.4), 0.25, size=(70, 2)),
    ]).astype(np.float32)
    fe = free_energies(populations(coords, [0.3], RB, CB, device="cpu")[0.3])
    nn = nearest_neighbors(coords, fe, RB, CB, device="cpu")
    order = tdensity.sorted_fe_order(fe)
    # a seed from another linking distance: a clustering that is not this
    # series' fixpoint
    seed = jdensity.screening_step(fe, nn[1] * np.float32(0.25), 1.0, coords,
                                   None, order=order,
                                   coords_sorted=coords[order],
                                   engine=jscreening.ScreeningEngine(
                                       coords[order], RB, CB, "pallas"))
    return dict(coords=coords, fe=fe, nh_d=nn[1], order=order,
                cs=coords[order], seed=seed)


def _series(step, engine, inputs, start, incremental):
    """The clusterings of THRESHOLDS from ``start``, then a repeat of the
    last threshold (the early return)."""
    d = inputs
    prev, out = start, []
    for t in THRESHOLDS + THRESHOLDS[-1:]:
        prev = step(d["fe"], d["nh_d"], t, d["coords"], prev,
                    order=d["order"], coords_sorted=d["cs"], engine=engine,
                    incremental=incremental and prev is not None)
        out.append(np.asarray(prev))
    return out


@pytest.mark.parametrize("start", ["none", "seeded"])
@pytest.mark.parametrize("incremental", [False, True])
def test_screening_step_equals_jax(inputs, start, incremental):
    seed = None if start == "none" else inputs["seed"]
    jeng = jscreening.ScreeningEngine(inputs["cs"], RB, CB, "pallas")
    teng = tscreening.ScreeningEngine(inputs["cs"], RB, CB, device="cpu")
    want = _series(jdensity.screening_step, jeng, inputs, seed, incremental)
    got = _series(tdensity.screening_step, teng, inputs, seed, incremental)
    for t, g, w in zip(THRESHOLDS + THRESHOLDS[-1:], got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w, err_msg=f"threshold {t}")
    # the repeat returned a copy of the previous result
    np.testing.assert_array_equal(got[-1], got[-2])
    assert got[-1] is not got[-2]
    assert len(np.unique(got[-1])) > 3
    if incremental and seed is None:
        # a continuation sweeps only tiles touching the new frames
        assert teng.last_stats["tiles_per_sweep"] > 0


def test_screening_step_builds_its_engine_on_device(inputs):
    """No ``order``, ``coords_sorted`` or ``engine``: the FE sort and a
    default-block engine on ``device``, the same result."""
    d = inputs
    got = tdensity.screening_step(d["fe"], d["nh_d"], 1.5, d["coords"], None,
                                  device="cpu")
    want = jdensity.screening_step(d["fe"], d["nh_d"], 1.5, d["coords"], None,
                                   engine=jscreening.ScreeningEngine(
                                       d["cs"], RB, CB, "pallas"))
    np.testing.assert_array_equal(got, want)


def test_screening_step_series_equals_the_series_screener(inputs):
    d = inputs
    md2 = np.float32(4.0 * compute_sigma2(d["nh_d"]))
    series = tscreening.ThresholdSeriesScreener(d["coords"], d["fe"],
                                                THRESHOLDS, RB, CB,
                                                device="cpu")
    teng = tscreening.ScreeningEngine(d["cs"], RB, CB, device="cpu")
    steps = _series(tdensity.screening_step, teng, inputs, None, True)
    prev = None
    for k, want in enumerate(steps[:len(THRESHOLDS)]):
        prev = series.step(prev, k, md2)
        np.testing.assert_array_equal(prev, want, err_msg=f"step {k}")
