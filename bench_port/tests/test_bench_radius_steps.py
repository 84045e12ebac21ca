"""The reader of ``kernels.pops_radius_steps`` on canned ``-v`` logs: the
``pops_bidir.radius_steps`` counter of the main thread's
``populations.sweep`` span, the mean of the window's jobs; nothing where
a job's span lacks the counter (a kernel that counts no steps) or its log
lacks the spans line."""

import json
from types import SimpleNamespace

import pytest

from bench_port import spec as specs

NAME = "kernels.pops_radius_steps"
S = 1_000_000_000
T0 = 1_790_000_000 * S


def sp(sid, name, thread="MainThread", **counters):
    return {"id": sid, "parent": None, "name": name, "thread": thread,
            "tid": 7, "start_ns": T0 + sid * S, "end_ns": T0 + (sid + 1) * S,
            "cpu_ns": 0, "counters": counters, "args": {}}


def log(steps, warm_steps=None):
    """A job's log whose sweep counted ``steps`` radius bodies (None: no
    counter), a warm thread's sweep ``warm_steps``."""
    sweep = {"radii": 8, "pops_bidir.tiles": 196, "pops_bidir.launches": 1}
    if steps is not None:
        sweep.update({"pops_bidir.warp_steps": 4 * steps,
                      "pops_bidir.radius_steps": steps})
    spans = [sp(1, "populations.radius_masks", mask_bits=700),
             sp(2, "populations.sweep", **sweep)]
    if warm_steps is not None:
        spans.append(sp(3, "populations.sweep", thread="warm-stages",
                        **{"pops_bidir.radius_steps": warm_steps}))
    line = json.dumps({"clock": "unix_ns", "pid": 1, "dropped": 0,
                       "spans": spans}, separators=(",", ":"))
    return "    [populations: 2.000s]\n[spans] " + line + "\n"


def read(*logs):
    ctx = SimpleNamespace(jobs=[{"wall": 30.0, "log": text}
                                for text in logs])
    return specs.metric_reader(NAME)(ctx)


def test_reads_the_sweeps_counter_mean_over_jobs():
    assert read(log(1200, warm_steps=9)) == 1200
    assert read(log(1000), log(1400)) == pytest.approx(1200)


def test_reads_nothing_without_the_counter():
    assert read(log(None)) is None
    assert read(log(1200), log(None)) is None
    assert read("    [populations: 2.000s]\n") is None


def test_listed_for_the_scan_cell_only():
    spec = specs.benchmark()
    entry = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert len(entry) == 1 and entry[0]["workloads"] == ["cli-10m-scan8"]
    assert [m["name"] for m in specs.metrics_of(
        spec, "cli-10m-scan8", "per_layer")][-1] == NAME
    assert NAME not in [m["name"] for m in specs.metrics_of(
        spec, "cli-10m", "per_layer")]
