"""On the card: the reference's arithmetic, a small cell of each entry
end to end, and the control. Run there with
``python -m pytest bench_port/tests -m cuda``."""

import numpy as np
import pytest
import torch

from bench_port import control, fel, run as runs, spec as specs
from bench_port.reference import density as rd

from _bench_tiny import tiny_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
def test_reference_is_the_cards_fma_chain(card):
    x = fel.coords_f32(fel.micro_units(fel.synthetic_fel(1 << 16, 4, 3)))
    x = torch.as_tensor(x, device=card)
    acc = torch.zeros(256, len(x), device=card)
    for k in range(4):
        d = x[:256, k, None] - x[None, :, k]
        acc = torch.addcmul(acc, d, d)
    got = rd.sq_dists(x[:256], x)
    assert torch.equal(got, acc)
    assert torch.equal(got.cpu(), rd.sq_dists(x[:256].cpu(), x.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", ["cli-t4", "api-t20"])
def test_small_cell_on_the_card(card, monkeypatch, traffic):
    cell = tiny_cell(monkeypatch, traffic, n_frames=1 << 16)
    monkeypatch.delenv("CLUSTERING_TORCH_DEVICE")
    spec = specs.benchmark()
    got = runs.run_cell(spec, cell, 2 ** 31 + 3, 1.0, 1)
    assert got["correct"] is True, got["checks"]
    assert got["device"]["platform"] == "gpu"
    assert got["device"]["busy_s"] > 0
    assert "kernels.pops_roofline" in got["metrics"]
    assert 0 < got["metrics"]["kernels.pops_roofline"]["value"] <= 100


@pytest.mark.cuda
def test_control_on_the_card(card, monkeypatch):
    cell = tiny_cell(monkeypatch, "cli-t4", n_frames=1 << 16)
    monkeypatch.delenv("CLUSTERING_TORCH_DEVICE")
    got = control.readings(cell, 7)
    limits = specs.traffic("cli-t4")["limits"]
    assert all(got["program"][k] <= limits[k] for k in got["program"])
    assert got["control"]["pops_wrong"] > limits["pops_wrong"]
    assert np.isfinite(got["control"]["nn_d2_gap"])
