"""The control comes out not correct, and so does a run whose timed path
is broken underneath, each fault planted in the program."""

import numpy as np
import pytest

from bench_port import control, run as runs, spec as specs
from bench_port.checks import density

from _bench_tiny import tiny_cell

LIMITS = specs.traffic("cli-t4")["limits"]

FAULTS = '''
import os
fault = os.environ.get("BENCH_PORT_TEST_FAULT")
if fault:
    from clustering_tpu_torch.ops import engine, screening
    if fault == "unchanged":
        # every threshold's step returns the first step's state
        real_step = screening.ThresholdSeriesScreener.step_submit
        def step_submit(self, k, max_dist2, pool):
            fut = real_step(self, k, max_dist2, pool)
            if k == 0:
                self._fault_first = fut
            return self._fault_first
        screening.ThresholdSeriesScreener.step_submit = step_submit
    elif fault == "joined":
        # every step joins frames up to twice the linking distance
        real_step = screening.ThresholdSeriesScreener.step_submit
        def step_submit(self, k, max_dist2, pool):
            return real_step(self, k, max_dist2 * 4, pool)
        screening.ThresholdSeriesScreener.step_submit = step_submit
    elif fault == "half":
        # the populations count half of the frames
        real_pops = engine.DensityEngine.populations
        def populations(self, radii, *a, **kw):
            out = real_pops(self, radii, *a, **kw)
            return {r: (p + 1) // 2 for r, p in out.items()}
        engine.DensityEngine.populations = populations
    elif fault == "altered":
        # every 50th nearest neighbour altered where it is produced
        real_nn = engine.DensityEngine.nearest_neighbors
        def nearest_neighbors(self, fe, *a, **kw):
            nh, d2, hd, hd2 = real_nn(self, fe, *a, **kw)
            nh = nh.copy()
            nh[::50] = (nh[::50] + 1) % len(nh)
            return nh, d2, hd, hd2
        engine.DensityEngine.nearest_neighbors = nearest_neighbors
'''


def failed_numbers(numbers, limits):
    return [k for k, v in numbers.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("traffic", ["api-t20", "cli-t4"])
def test_control_fails_the_program_passes(monkeypatch, traffic):
    cell = tiny_cell(monkeypatch, traffic, n_frames=2000)
    got = control.readings(cell, 21, device="cpu")
    limits = specs.traffic(traffic)["limits"]
    assert failed_numbers(got["program"], limits) == []
    assert "pops_wrong" in failed_numbers(got["control"], limits)
    assert "nn_d2_gap" in failed_numbers(got["control"], limits)


@pytest.mark.parametrize("fault,caught", [("unchanged", "clust_wrong"),
                                          ("joined", "clust_joined"),
                                          ("half", "pops_wrong"),
                                          ("altered", "nn_wrong")])
def test_faults_make_a_run_incorrect(monkeypatch, tmp_path, fault, caught):
    (tmp_path / "sitecustomize.py").write_text(FAULTS)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setenv("BENCH_PORT_TEST_FAULT", fault)
    cell = tiny_cell(monkeypatch, "cli-t4", n_frames=2000)
    spec = {"end_to_end": [], "per_layer": []}
    got = runs.run_cell(spec, cell, 22, 0.1, 0, device="cpu",
                        check_device=False)
    assert got["correct"] is False
    assert got["checks"][caught]["value"] > got["checks"][caught]["limit"]


def test_with_answers_replaces_only_the_sample():
    n = 10
    out = {"pops": np.arange(1, n + 1), "fe": np.zeros(n),
           "nh_id": np.zeros(n, np.int64), "nh_d2": np.ones(n),
           "hd_id": np.zeros(n, np.int64), "hd_d2": np.ones(n),
           "clust": []}
    rows = np.asarray([2, 5])
    ans = {"pop": np.asarray([7, 7]), "nh_id": np.asarray([1, 1]),
           "nh_d2": np.asarray([0.5, np.inf]), "hd_id": np.asarray([3, 3]),
           "hd_d2": np.asarray([0.25, 0.25])}
    got = control.with_answers(out, rows, ans)
    assert got["pops"].tolist() == [1, 2, 7, 4, 5, 7, 7, 8, 9, 10]
    assert got["nh_d2"].tolist()[5] == 0.0 and got["nh_d2"][2] == 0.5
    assert np.allclose(got["fe"][rows], density.free_energy32(got["pops"])[rows])
    assert out["pops"][2] == 3
