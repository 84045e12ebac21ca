"""The result line's keys, and no result without a card."""

import json
import subprocess
import sys

import pytest

from bench_port import run, spec as specs

from _bench_tiny import tiny_cell


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(run.torch.cuda, "is_available", lambda: False)
    with pytest.raises(run.RunFailed):
        run.device_info(1)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False\n"
         "from bench_port import run; sys.exit(run.main(sys.argv[1:]))",
         "--workload", "cli-10m", "--seed", "1", "--seconds", "1"],
        cwd=specs.ROOT, capture_output=True, text=True)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_result_keys(monkeypatch):
    cell = tiny_cell(monkeypatch, "api-t20", n_frames=1500)
    spec = {"end_to_end": specs.benchmark()["end_to_end"],
            "per_layer": specs.benchmark()["per_layer"]}
    got = run.run_cell(spec, cell, 5, 0.5, 0, device="cpu",
                       check_device=False)
    assert list(got) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert got["correct"] is True and got["failed"] == 0
    assert set(got["metrics"]) == {"job_s", "peak_device_GB", "setup_s"}
    assert got["checks"]["pops_wrong"] == {"value": 0, "limit": 0}
    json.dumps(got)
    traced = run.run_cell(spec, cell, 5, 0.5, 1, device="cpu",
                          check_device=False)
    assert list(traced)[-1] == "checks"
    assert {"populations.wall_s", "nn.wall_s",
            "screening.wall_s"} <= set(traced["metrics"])
