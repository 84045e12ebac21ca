"""The readers of the program's spans line (``spans.py`` and the six
metrics on it), on a canned log and job wall."""

import json
from types import SimpleNamespace

import pytest

from bench_port import spans, stages
from bench_port import spec as specs

S = 1_000_000_000  # ns a second
T0 = 1_790_000_000 * S


def sp(sid, name, start, end, thread="MainThread", parent=None, **counters):
    """A span of the line, its start and end in seconds after T0."""
    return {"id": sid, "parent": parent, "name": name, "thread": thread,
            "tid": 7, "start_ns": T0 + int(start * S),
            "end_ns": T0 + int(end * S), "cpu_ns": 0, "counters": counters,
            "args": {}}


# a job of 10 s on the harness's clock: the main thread's spans cover
# 0-2 (cli.start, with cli.imports inside), 2-3.5 (the read), 4-6
# (populations), 6-8.5 (NN, with phase 2's tiles) and 9-9.25 (two waits
# on writes); 3.5-4 and 8.5-9 are unnamed; the worker threads' spans
# (the screener's build, a warm's NN with tiles of its own) overlap them
SPANS = [
    sp(2, "cli.imports", 0.5, 1.5, parent=1),
    sp(1, "cli.start", 0.0, 2.0),
    sp(3, "io.read_coords", 2.0, 3.5, rows=10, bytes=100),
    sp(4, "populations", 4.0, 6.0),
    sp(6, "nn.phase2", 7.0, 8.0, parent=5, phase2_tiles=1200),
    sp(5, "nearest neighbors", 6.0, 8.5),
    sp(7, "screener.build", 6.5, 9.5, thread="write_1", parent=5),
    sp(8, "nn.phase2", 1.0, 1.5, thread="warm-stages", phase2_tiles=9),
    sp(9, "cli.write_wait", 9.0, 9.125),
    sp(10, "cli.write_wait", 9.125, 9.25),
]
LINE = "[spans] " + json.dumps({"clock": "unix_ns", "pid": 1, "dropped": 0,
                                "spans": SPANS}, separators=(",", ":"))
LOG = """~~~ free energy and population
    [pops: 196 tiles computed = 25.7% of N^2 incl. padding]
    [populations: 2.000s]
    [nn: 1300 tiles computed = 62.9% of N^2 incl. padding, tiered phase 2]
    [nearest neighbors: 2.500s]
~~~ freeing memory
"""

WANT = {"cli.start_s": 2.0, "io.read_s": 1.5, "io.write_wait_s": 0.25,
        "screening.build_s": 3.0, "nn.phase2_tiles": 1200,
        "cli.unspanned_s": 10.0 - (2.0 + 1.5 + 2.0 + 2.5 + 0.25)}


def reader(name):
    return specs.metric_reader(name)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_canned_line(name):
    ctx = SimpleNamespace(jobs=[{"wall": 10.0, "log": LOG + LINE + "\n"}])
    assert reader(name)(ctx) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_the_line_reads_nothing(name):
    """A program without the recorder (no spans line) gives None, not 0,
    and so does a window where one job lacks the line."""
    bare = SimpleNamespace(jobs=[{"wall": 10.0, "log": LOG}])
    assert reader(name)(bare) is None
    mixed = SimpleNamespace(jobs=[{"wall": 10.0, "log": LOG + LINE},
                                  {"wall": 10.0, "log": LOG}])
    assert reader(name)(mixed) is None
    api = SimpleNamespace(jobs=[{"wall": 2.0, "measured": {}}])
    assert reader(name)(api) is None


def test_readers_average_the_window():
    later = [dict(s, start_ns=s["start_ns"] + 5 * S,
                  end_ns=s["end_ns"] + 5 * S) for s in SPANS]
    for s in later:
        if s["name"] == "io.read_coords":
            s["end_ns"] += S // 2
    line2 = "[spans] " + json.dumps({"spans": later})
    ctx = SimpleNamespace(jobs=[{"wall": 10.0, "log": LOG + LINE},
                                {"wall": 11.0, "log": LOG + line2}])
    assert reader("io.read_s")(ctx) == pytest.approx(1.75)
    assert reader("cli.unspanned_s")(ctx) == pytest.approx(
        WANT["cli.unspanned_s"] + 0.25)


def test_union_and_counters():
    assert spans.covered_s(SPANS) == pytest.approx(8.25)
    assert spans.covered_s(SPANS, "write_1") == pytest.approx(3.0)
    assert spans.counter(SPANS, "phase2_tiles") == 1200
    assert spans.counter(SPANS, "phase2_tiles", "warm-stages") == 9
    assert spans.counter(SPANS, "band_tiles") is None
    assert spans.wall_s(SPANS, "absent") is None
    assert spans.of_log(LOG) is None


def test_the_line_leaves_the_stage_readers_unchanged():
    """``stages.py``'s patterns find nothing in the spans line."""
    assert stages.measured(LOG + LINE + "\n", 10.0) == stages.measured(
        LOG, 10.0)
    assert stages.walls(LINE) == {} and stages.substages(LINE) == {}
    assert stages.tiles(LINE) == {}
