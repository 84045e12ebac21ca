"""The readers of the mesh's four metrics on canned ``-v`` logs:
``mesh.plan_s`` and ``mesh.merge_s`` sum their spans' walls,
``mesh.tile_skew`` takes the largest ``tiles_max_over_mean`` of the main
thread's spans and ``mesh.plan_matrix_GB`` the largest
``matrix_bytes_max`` of the ``mesh.plan`` spans; each is the mean (the
matrix: the largest) over the window's jobs, and nothing where a job's
log has no such span, as a program without the row deal writes."""

import json
from types import SimpleNamespace

import pytest

from bench_port import spec as specs

NAMES = ("mesh.plan_s", "mesh.merge_s", "mesh.tile_skew",
         "mesh.plan_matrix_GB")
CELL = "cli-40m-x4"
S = 1_000_000_000
T0 = 1_790_000_000 * S


def sp(sid, name, seconds, thread="MainThread", **counters):
    start = T0 + sid * S
    return {"id": sid, "parent": None, "name": name, "thread": thread,
            "tid": 7, "start_ns": start, "end_ns": start + int(seconds * S),
            "cpu_ns": 0, "counters": counters, "args": {}}


def log(scale=1.0, mesh=True):
    """A job's log: on a mesh, two ``mesh.plan`` spans (0.5 s and 0.25 s,
    the larger matrix 3.05e9 bytes), two merges (0.125 s and 0.0625 s)
    and three stages' skews (the largest 1.25; a warm thread's 9.0 does
    not count), all times ``scale``."""
    spans = [sp(1, "populations.sweep", 2.0, radii=1,
                **({"tiles_max_over_mean": 1.0625} if mesh else {}))]
    if mesh:
        spans += [
            sp(2, "mesh.plan", 0.5 * scale, rows_max=78128,
               matrix_bytes_max=int(3.05e9 * scale)),
            sp(3, "mesh.plan", 0.25 * scale, rows_max=78128,
               matrix_bytes_max=int(0.76e9)),
            sp(4, "mesh.merge", 0.125 * scale, bytes=480_000_000),
            sp(5, "mesh.merge", 0.0625 * scale, bytes=960_000_000),
            sp(6, "nn.phase2", 3.0, phase2_tiles=10,
               tiles_max_over_mean=1.25 * scale),
            sp(7, "screening.fixpoint", 0.5, tiles_max_over_mean=1.125),
            sp(8, "populations.sweep", 0.1, thread="warm-stages",
               tiles_max_over_mean=9.0)]
    line = json.dumps({"clock": "unix_ns", "pid": 1, "dropped": 0,
                       "spans": spans}, separators=(",", ":"))
    return "    [populations: 2.000s]\n[spans] " + line + "\n"


def read(name, *logs):
    ctx = SimpleNamespace(jobs=[{"wall": 80.0, "log": text}
                                for text in logs])
    return specs.metric_reader(name)(ctx)


def test_reads_the_mesh_spans_and_counters():
    assert read("mesh.plan_s", log()) == pytest.approx(0.75)
    assert read("mesh.merge_s", log()) == pytest.approx(0.1875)
    assert read("mesh.tile_skew", log()) == pytest.approx(1.25)
    assert read("mesh.plan_matrix_GB", log()) == pytest.approx(3.05)


def test_mean_over_jobs_and_the_largest_matrix():
    assert read("mesh.plan_s", log(), log(3.0)) == pytest.approx(1.5)
    assert read("mesh.tile_skew", log(), log(1.2)) == pytest.approx(
        1.25 * 1.1)
    assert read("mesh.plan_matrix_GB", log(), log(0.5)) == pytest.approx(
        3.05)


@pytest.mark.parametrize("name", NAMES)
def test_reads_nothing_without_a_mesh(name):
    assert read(name, log(mesh=False)) is None
    assert read(name, log(), log(mesh=False)) is None
    assert read(name, "    [populations: 2.000s]\n") is None


@pytest.mark.parametrize("name", NAMES)
def test_listed_for_the_four_card_cell_only(name):
    spec = specs.benchmark()
    entry = [m for m in spec["per_layer"] if m["name"] == name]
    assert len(entry) == 1 and entry[0]["workloads"] == [CELL]
    assert name in [m["name"] for m in specs.metrics_of(
        spec, CELL, "per_layer")]
    for other in ("cli-10m", "api-1m-t20", "cli-10m-scan8"):
        assert name not in [m["name"] for m in specs.metrics_of(
            spec, other, "per_layer")]
    assert entry[0]["moves"] == ("peak_device_GB" if name.endswith("_GB")
                                 else "job_s")


def test_the_cell_and_its_configuration():
    spec = specs.benchmark()
    cell = specs.cell(spec, CELL)
    assert cell["chips"] == 4 and cell["traffic"] == "cli-t4"
    cfg = specs.config(cell["config"])
    assert cfg["n_frames"] == 40_000_000 and cfg["dim"] == 4
    assert cfg["radius"] == 0.1 and cfg["reference"] == "density"
    entry = [c for c in spec["configs"] if c["name"] == cell["config"]]
    assert entry[0]["reduced"] == [] and entry[0]["source"] == cfg["source"]
