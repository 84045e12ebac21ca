"""Cells added as files and entries, in a copy of the benchmark, are found
and judged with no code edited: a configuration, a traffic mix, a metric
and a cell whose jobs write what today's cells write; and a cell of
another output shape, a scan of several radii (``-R``) through the CLI
entry, with a comparison of its own."""

import filecmp
import json
import os
import subprocess
import sys

from bench_port import spec as specs

from _bench_tiny import TINY, copy_benchmark

RUN = ("import json, sys\n"
       "from bench_port import run, spec\n"
       "s = spec.benchmark()\n"
       "r = run.run_cell(s, spec.cell(s, sys.argv[1]), 9, 0.5, 0,"
       " device='cpu', check_device=False)\n"
       "print(json.dumps(r))\n")

RADII = [0.05, 0.1, 0.15]

# the comparison of the scan: per radius, the sampled frames whose
# population differs from the plain reference's; and the CLI's agreement
SCAN = '''
import torch

from bench_port import check, spec


def judge(run, jobs):
    ref = spec.reference(run.config["reference"])
    coords = torch.as_tensor(run.coords, device=check.device(run))
    rows = check.sample_rows(run.seed, len(run.coords),
                             run.config["sample_frames"])
    ids = torch.as_tensor(rows, device=coords.device)
    want = {r: ref.populations(coords, ids, r) for r in run.config["radii"]}
    numbers = check.worst(
        {f"pops_wrong_{r:g}": int((check.table(run, rec, f"pop_{r:f}")
                                   [rows, 0] != want[r]).sum())
         for r in want} for rec in run.entry.judged(run, jobs))
    numbers.update(run.entry.agreement(run, jobs))
    return numbers, dict(run.traffic["limits"])
'''

# one count of the first job's 0.1 file changed once its files are
# fingerprinted, before the check reads them
CORRUPT = '''
import os
from bench_port.entries import cli
real_finish = cli.finish


def finish(run, rec, first):
    real_finish(run, rec, first)
    if first:
        path = os.path.join(rec["dir"], "pop_0.100000")
        with open(path) as fh:
            lines = fh.read().split("\\n")
        k = next(i for i, line in enumerate(lines) if line[:1] != "#")
        lines[k] = str(int(lines[k]) + 1)
        with open(path, "w") as fh:
            fh.write("\\n".join(lines))


cli.finish = finish
'''


def add(tmp_path, files, cell, config, metric=None):
    """Write ``files`` ({path under bench_port: text}) into a copy of the
    benchmark in ``tmp_path``, and the cell, its configuration and
    ``metric`` into its ``BENCHMARK.json``."""
    bench = copy_benchmark(str(tmp_path))
    for path, text in files.items():
        (tmp_path / "bench_port" / path).write_text(text)
    bench["configs"].append({"name": cell["config"], "source": "test",
                             "file": f"bench_port/configs/{config}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append(dict(cell, chips=1, why="test"))
    if metric:
        bench["end_to_end"].append(metric)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


def assert_only_added(tmp_path, files):
    """Every file of the copy's ``bench_port`` is the repo's, unchanged,
    or one of ``files``, and each of ``files`` is there."""
    seen = set()
    for dirpath, dirs, names in os.walk(tmp_path / "bench_port"):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in names:
            rel = os.path.relpath(os.path.join(dirpath, name),
                                  tmp_path / "bench_port")
            seen.add(rel)
            if rel not in files:
                assert filecmp.cmp(os.path.join(dirpath, name),
                                   os.path.join(specs.HERE, rel),
                                   shallow=False), rel
    assert set(files) <= seen


def run_cell(tmp_path, name, prelude=""):
    env = dict(os.environ, CLUSTERING_TORCH_DEVICE="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", prelude + RUN, name],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_added_files_are_found(tmp_path):
    files = {
        "configs/tiny.json": json.dumps(
            dict(TINY, n_frames=1000, sample_frames=100)),
        "traffic/api-t3.json": json.dumps(
            {"entry": "api", "thresholds": [0.5, 1.0, 1.5],
             "limits": {"pops_wrong": 0, "fe_gap": 1e-5, "nn_wrong": 0,
                        "nn_d2_gap": 1e-4, "clust_wrong": 0}}),
        "metrics/frames.py": "def read(ctx):\n    return ctx.n\n"}
    add(tmp_path, files,
        {"name": "tiny-t3", "config": "tiny", "traffic": "api-t3"}, "tiny",
        {"name": "frames", "unit": "frames", "better": "higher",
         "bound": 0.01, "source": "host_clock", "workloads": ["tiny-t3"]})
    assert_only_added(tmp_path, files)
    result = run_cell(tmp_path, "tiny-t3")
    assert result["correct"] is True
    assert result["metrics"]["frames"] == {"value": 1000, "unit": "frames"}
    assert "peak_host_GB" not in result["metrics"]
    assert len(result["checks"]) == 6


def test_added_output_shape_is_judged(tmp_path):
    """A cell whose jobs write k population and k free-energy files, and
    no neighbours or clusterings, judged by a comparison of its own; a
    changed count fails it."""
    names = [f"{kind}_{r:f}" for kind in ("pop", "fe") for r in RADII]
    limits = {f"pops_wrong_{r:g}": 0 for r in RADII}
    files = {
        "configs/tiny-scan.json": json.dumps(
            {"name": "tiny-scan", "source": "test", "n_frames": 1000,
             "dim": 4, "radii": RADII, "precision": "float32",
             "reference": "density", "sample_frames": 1000}),
        "traffic/cli-scan.json": json.dumps(
            {"entry": "cli", "check": "scan",
             "args": ["-R"] + [str(r) for r in RADII]
             + ["-p", "pop", "-d", "fe", "-v"],
             "files": names, "limits": dict(limits, jobs_differ=0)}),
        "checks/scan.py": SCAN}
    add(tmp_path, files, {"name": "tiny-scan", "config": "tiny-scan",
                          "traffic": "cli-scan"}, "tiny-scan")
    assert_only_added(tmp_path, files)
    sound = run_cell(tmp_path, "tiny-scan")
    assert sound["correct"] is True, sound["checks"]
    assert set(sound["checks"]) == set(limits) | {"jobs_differ",
                                                  "jobs_failed"}
    assert all(c["value"] == 0 for c in sound["checks"].values())
    assert {"job_s", "setup_s"} <= set(sound["metrics"])
    bad = run_cell(tmp_path, "tiny-scan", CORRUPT)
    assert bad["correct"] is False
    assert bad["checks"]["pops_wrong_0.1"] == {"value": 1, "limit": 0}
    assert bad["checks"]["pops_wrong_0.05"]["value"] == 0
