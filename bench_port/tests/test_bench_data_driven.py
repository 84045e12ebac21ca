"""A configuration, a traffic mix, a metric and a cell added as files and
entries, in a copy of the benchmark, are found with no code edited."""

import json
import os
import subprocess
import sys

from _bench_tiny import TINY, copy_benchmark

RUN = ("import json, sys\n"
       "from bench_port import run, spec\n"
       "s = spec.benchmark()\n"
       "r = run.run_cell(s, spec.cell(s, 'tiny-t3'), 9, 0.5, 0,"
       " device='cpu', check_device=False)\n"
       "print(json.dumps(r))\n")


def test_added_files_are_found(tmp_path):
    bench = copy_benchmark(str(tmp_path))
    here = tmp_path / "bench_port"
    (here / "configs" / "tiny.json").write_text(json.dumps(
        dict(TINY, n_frames=1000, sample_frames=100)))
    (here / "traffic" / "api-t3.json").write_text(json.dumps(
        {"entry": "api", "thresholds": [0.5, 1.0, 1.5],
         "limits": {"pops_wrong": 0, "fe_gap": 1e-5, "nn_wrong": 0,
                    "nn_d2_gap": 1e-4, "clust_wrong": 0}}))
    (here / "metrics" / "frames.py").write_text(
        "def read(ctx):\n    return ctx.n\n")
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "bench_port/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-t3", "config": "tiny",
                               "traffic": "api-t3", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "frames", "unit": "frames",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["tiny-t3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, CLUSTERING_TORCH_DEVICE="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["frames"] == {"value": 1000, "unit": "frames"}
    assert "peak_host_GB" not in result["metrics"]
    assert len(result["checks"]) == 6
