"""The port's spans (``clustering_tpu_torch.utils.timer``): the density
CLI's span tree on make_golden's input, the sub-stage times as read-outs
of the spans, the ``[spans]`` line's switch and bound, the benchmark's
log readers unchanged by the line, and the spans of a profiled CLI
process on the trace's clock."""

import contextlib
import functools
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_port import stages
from clustering_tpu_torch import cli as tcli
from clustering_tpu_torch.models import density as tdensity
from clustering_tpu_torch.ops import density as tdops
from clustering_tpu_torch.ops import engine as tengine
from clustering_tpu_torch.ops import screening as tscreening
from clustering_tpu_torch.utils import timer

ROOT = pathlib.Path(__file__).resolve().parents[1]
RB, CB = 8, 16
ARGV = ["density", "-f", "coords.dat", "-r", "0.2", "-p", "pop", "-d", "fe",
        "-b", "nn", "-o", "clust", "-T", "0.3", "0.3", "1.2", "-v"]
STEPS = ["screening 0.30", "screening 0.60", "screening 0.90",
         "screening 1.20"]
MAIN = "MainThread"


def _golden_coords():
    """make_golden's input: three blobs, 350 frames in 2-D."""
    rng = np.random.default_rng(20260816)
    a = rng.normal((0.0, 0.0), 0.12, size=(160, 2))
    b = rng.normal((1.2, 0.1), 0.15, size=(120, 2))
    c = rng.normal((-0.3, 1.5), 0.10, size=(70, 2))
    coords = np.concatenate([a, b, c]).astype(np.float32)
    return coords[rng.permutation(len(coords))]


def _spans_of(log):
    lines = [ln for ln in log.splitlines() if ln.startswith("[spans] ")]
    assert len(lines) == 1 and log.rstrip().endswith(lines[0])
    return json.loads(lines[0][len("[spans] "):])["spans"]


def _run_cli(workdir, env, warms=False):
    """The density CLI in this process on make_golden's input, its engine
    on blocks (8, 16) so that populations starts the band prefetch;
    ``warms`` forces the CUDA-only warm threads on. Returns its log."""
    failures = []
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        mp.setenv(tcli.DEVICE_ENV, "cpu")
        mp.delenv(tcli.SUBSTAGES_ENV, raising=False)
        for key, val in env.items():
            mp.setenv(key, val)
        mp.setattr(tdensity, "DensityEngine", functools.partial(
            tengine.DensityEngine, row_block=RB, col_block=CB))
        if warms:
            mp.setattr(tdensity, "_precompile_on", lambda engine: True)
            for mod in (tengine, tscreening):
                mp.setattr(mod, "warm_on", lambda device, mesh: True)
            for mod in (tengine, tscreening, tdensity):
                mp.setattr(mod, "warm_failed",
                           lambda what, exc: failures.append((what, exc)))
        np.savetxt("coords.dat", _golden_coords(), fmt="%.6f")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert tcli.main(ARGV) == 0
    assert failures == []
    return out.getvalue()


@pytest.fixture(scope="module")
def cli_log(tmp_path_factory):
    return _run_cli(tmp_path_factory.mktemp("spans"),
                    {tcli.SUBSTAGES_ENV: "1"}, warms=True)


def _by_id(spans):
    return {s["id"]: s for s in spans}


def _in_warm(spans, s):
    """Whether ``s`` runs inside a warm (on the warms' scratch engines)."""
    by_id = _by_id(spans)
    while s is not None:
        if s["name"].startswith("warm."):
            return True
        s = by_id.get(s["parent"])
    return False


@pytest.fixture(scope="module")
def all_spans(cli_log):
    return _spans_of(cli_log)


@pytest.fixture(scope="module")
def cli_spans(all_spans):
    """The job's own spans, without those inside the warms."""
    return [s for s in all_spans if not _in_warm(all_spans, s)]


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def _parent_name(spans, s):
    p = _by_id(spans).get(s["parent"])
    return None if p is None else p["name"]


# (span, its parent's name, its thread's name or prefix)
TREE = [
    ("cli.start", None, MAIN), ("cli.imports", "cli.start", MAIN),
    ("io.read_coords", None, MAIN), ("density.setup", None, MAIN),
    ("populations", None, MAIN),
    ("populations.plan", "populations", MAIN),
    ("populations.best_sort", "populations.plan", MAIN),
    ("layout.upload.frames", "populations.best_sort", MAIN),
    ("layout.sort.dim0", "populations.best_sort", MAIN),
    ("layout.upload.dim0", "populations.best_sort", MAIN),
    ("layout.bbox.dim0", "populations.best_sort", MAIN),
    ("layout.sort.morton", "populations.best_sort", MAIN),
    ("layout.upload.morton", "populations.best_sort", MAIN),
    ("layout.bbox.morton", "populations.best_sort", MAIN),
    ("populations.radius_masks", "populations.plan", MAIN),
    ("populations.sweep", "populations", MAIN),
    ("populations.download", "populations", MAIN),
    ("populations.finish", "populations", MAIN),
    ("density.free_energies", None, MAIN),
    ("nn.band_prefetch", "populations", "band-prefetch"),
    ("nearest neighbors", None, MAIN),
    ("nn.band_wait", "nearest neighbors", MAIN),
    ("nn.phase2", "nearest neighbors", MAIN),
    ("nn.download", "nearest neighbors", MAIN),
    ("screener.build", "nearest neighbors", "write_"),
    ("screener.sort", "screener.build", "write_"),
    ("screener.fe_sort", "screener.build", "write_"),
    ("screener.gather", "screener.build", "write_"),
    ("screener.upload", "screener.build", "write_"),
    ("screening setup", None, MAIN),
    ("screener.hd_neighbors", "screening setup", MAIN),
    ("warm.pops", "density.setup", "warm-stages"),
    ("warm.nn", "density.setup", "warm-stages"),
    ("warm.screen_early", "nearest neighbors", "warm-screen-early"),
    ("warm.screen", "screening setup", "warm-screen"),
    ("cli.write_wait", None, MAIN), ("cli.teardown", None, MAIN),
] + [(step, None, MAIN) for step in STEPS]


@pytest.mark.parametrize("name,parent,thread", TREE,
                         ids=[t[0] for t in TREE])
def test_cli_span_parent_and_thread(all_spans, cli_spans, name, parent,
                                    thread):
    """Each span of the density CLI, with its parent and its thread (the
    warms' scratch stages, left out here, open the same names)."""
    spans = all_spans if name.startswith("warm.") else cli_spans
    found = _named(spans, name)
    assert found, name
    for s in found:
        assert _parent_name(spans, s) == parent, s
        assert s["thread"].startswith(thread), s


def test_cli_screener_takes_the_engines_morton_order(all_spans):
    """The CLI's screener is built from the Morton order that the density
    engine built for populations: no ``screener.morton`` span, and the
    build's ``morton_reused`` counter reads 1."""
    assert not _named(all_spans, "screener.morton")
    builds = _named(all_spans, "screener.build")
    assert len(builds) == 1
    assert builds[0]["counters"]["morton_reused"] == 1


@pytest.mark.parametrize("name", ["dim0", "morton"])
def test_cli_layout_sorts_count_where_they_ran(cli_spans, name):
    """The populations stage builds each layout once, inside
    ``populations.best_sort``, from one upload of the frames that comes
    first; the sort's ``on_device`` counter reads 0 on the CPU (1 where
    torch sorted on a CUDA device)."""
    sorts = _named(cli_spans, "layout.sort." + name)
    assert len(sorts) == 1
    s = sorts[0]
    assert _parent_name(cli_spans, s) == "populations.best_sort"
    assert s["counters"] == {"on_device": 0}
    best = _named(cli_spans, "populations.best_sort")[0]
    assert best["start_ns"] <= s["start_ns"] <= s["end_ns"] <= best["end_ns"]
    up, = _named(cli_spans, "layout.upload.frames")
    assert up["end_ns"] <= s["start_ns"]


def test_warm_threads_hold_only_the_warms(all_spans):
    """Every span on a warm thread, or opened by a warm, lies inside a
    ``warm.*`` span; the warms' stages ran (a band prefetch among them,
    on a thread of its own)."""
    on_warms = [s for s in all_spans if s["thread"].startswith("warm-")]
    assert len(on_warms) > 8
    for s in on_warms:
        assert _in_warm(all_spans, s), s
    inside = [s for s in all_spans if _in_warm(all_spans, s)]
    assert {"populations.sweep", "nn.phase2", "screening.fixpoint",
            "nn.band_prefetch"} <= {s["name"] for s in inside}


def test_cli_worker_and_step_spans(cli_spans):
    """The spans that repeat: each step's plan, fixpoint and postlude, the
    writes by file, the plans and the kernels' counters."""
    for name, thread in (("screening.plan", MAIN),
                         ("screening.fixpoint", MAIN),
                         ("screening.post", "post_")):
        found = _named(cli_spans, name)
        assert found, name
        for s in found:
            assert _parent_name(cli_spans, s) in STEPS
            assert s["thread"].startswith(thread)
    for s in _named(cli_spans, "screening.fixpoint"):
        assert s["counters"]["sweeps"] >= 1
        assert s["counters"]["swept_tiles"] >= 1
        assert s["counters"]["label_min_bidir.tiles"] >= 1
    writes = {s["args"]["file"]: s for s in _named(cli_spans, "io.write")}
    assert sorted(writes) == sorted(
        ["pop", "fe", "nn"] + [f"clust.{t}" for t in
                               ("0.30", "0.60", "0.90", "1.20")])
    for f, s in writes.items():
        parent = _parent_name(cli_spans, s)
        if f.startswith("clust."):
            assert parent == "screening " + f[6:] and s["thread"].startswith(
                "io_")
        else:
            assert parent == ("nearest neighbors" if f == "nn"
                              else "populations")
            assert s["thread"].startswith("write_")
        assert s["counters"]["rows"] == 350 and s["counters"]["bytes"] > 0
    read = _named(cli_spans, "io.read_coords")[0]
    assert read["counters"]["rows"] == 350 and read["counters"]["bytes"] > 0
    # the band pass ran on the prefetch thread, phase 2 on the main one
    pf = _named(cli_spans, "nn.band_prefetch")[0]
    assert pf["counters"]["band_tiles"] > 0
    assert pf["counters"]["nn_bidir.tiles"] == pf["counters"]["band_tiles"]
    p2 = _named(cli_spans, "nn.phase2")[0]
    assert p2["counters"]["phase2_tiles"] > 0
    assert p2["counters"]["nn_bidir.tiles"] == p2["counters"]["phase2_tiles"]
    plans = [_parent_name(cli_spans, s) for s in _named(cli_spans, "nn.plan")]
    assert "nearest neighbors" in plans and "nn.band_prefetch" in plans
    sweep = _named(cli_spans, "populations.sweep")[0]
    assert sweep["counters"]["pops_bidir.tiles"] > 0
    # no CUDA context here: no device peak; every span's CPU time is a
    # share of its wall on one thread
    for s in cli_spans:
        assert "peak_device_bytes" not in s["counters"]
        assert 0 <= s["cpu_ns"]
        assert s["start_ns"] <= s["end_ns"]


def test_cli_spans_nest_and_main_spans_are_disjoint(all_spans,
                                                    cli_spans):
    """A child on its parent's thread lies inside it; a child handed to
    another thread starts inside it; the main thread's top-level spans do
    not overlap."""
    by_id = _by_id(all_spans)
    for s in all_spans:
        p = by_id.get(s["parent"])
        if p is None:
            continue
        assert p["start_ns"] <= s["start_ns"], (p, s)
        if p["thread"] == s["thread"]:
            assert s["end_ns"] <= p["end_ns"], (p, s)
    tops = sorted((s for s in cli_spans
                   if s["parent"] is None and s["thread"] == MAIN),
                  key=lambda s: s["start_ns"])
    names = [s["name"] for s in tops]
    assert names == (["cli.start", "io.read_coords", "density.setup",
                      "populations", "density.free_energies",
                      "nearest neighbors", "screening setup"]
                     + STEPS + ["cli.write_wait", "cli.write_wait",
                                "cli.teardown", "cli.teardown"])
    for a, b in zip(tops, tops[1:]):
        assert a["end_ns"] <= b["start_ns"], (a, b)


def test_substage_lines_read_the_spans(cli_log, cli_spans):
    """The ``-v`` sub-stage lines print the spans' seconds."""
    subs = stages.substages(cli_log)
    pops = {k: _named(cli_spans, "populations." + k)[0]
            for k in ("plan", "best_sort", "sweep", "download", "finish")}

    def sec(s):
        return (s["end_ns"] - s["start_ns"]) / 1e9
    want = {"t_best_sort": sec(pops["best_sort"]),
            "t_plan": sec(pops["plan"]),
            "t_sweep": sec(pops["sweep"]) + sec(pops["download"]),
            "t_finish": sec(pops["finish"])}
    assert subs["populations"].keys() == want.keys()
    for key, val in want.items():
        assert subs["populations"][key] == pytest.approx(val, abs=6e-4), key


def _spans_since(fn):
    """(fn's result, the spans that ended while it ran)."""
    timer.reset()
    out = fn()
    return out, [s.as_dict() for s in timer.finished()]


def _sec(s):
    return (s["end_ns"] - s["start_ns"]) / 1e9


@pytest.mark.parametrize("prefetch", [True, False])
def test_last_stats_substages_equal_the_spans(prefetch):
    """Every ``t_`` key of ``last_stats`` is its spans' seconds: the
    populations' and NN's (band pass prefetched or on the main thread)
    and each screening step's."""
    coords = _golden_coords()
    eng = tengine.DensityEngine(coords, RB, CB, device="cpu")
    pops, spans = _spans_since(lambda: eng.populations(
        [0.2], nn_band_radius=0.2 if prefetch else None)[0.2])
    st = eng.last_stats["populations"]
    one = {s["name"]: s for s in spans if s["thread"] == MAIN}
    assert st["t_best_sort"] == _sec(one["populations.best_sort"])
    assert st["t_plan"] == _sec(one["populations.plan"])
    assert st["t_sweep"] == (_sec(one["populations.sweep"])
                             + _sec(one["populations.download"]))
    assert st["t_finish"] == _sec(one["populations.finish"])
    fe = tdops.free_energies(pops)
    _, spans = _spans_since(lambda: eng.nearest_neighbors(fe))
    st = eng.last_stats["nn"]
    assert st["band_prefetched"] is prefetch
    main = [s for s in spans if s["thread"] == MAIN]
    band = _named(main, "nn.band_wait" if prefetch else "nn.band")
    assert len(band) == 1
    plans = sorted(_named(main, "nn.plan"), key=lambda s: s["start_ns"])
    assert len(plans) == (1 if prefetch else 3)
    t_plan = 0.0
    for s in plans:
        t_plan += _sec(s)
    assert st["t_plan"] == t_plan
    in_band = sum(_sec(s) for s in plans[:-1])
    assert st["t_band"] == pytest.approx(_sec(band[0]) - in_band, abs=1e-12)
    assert st["t_sweep"] == (_sec(_named(main, "nn.phase2")[0])
                             + _sec(_named(main, "nn.download")[0]))
    series = tscreening.ThresholdSeriesScreener(coords, fe, [0.3, 0.6],
                                                RB, CB, device="cpu")
    md2 = np.float32(4.0 * np.mean(eng.nearest_neighbors(fe)[1]))
    prev = None
    for k in range(2):
        prev, spans = _spans_since(lambda: series.step(prev, k, md2))
        st = series.engine.last_stats
        assert st["t_plan"] == _sec(_named(spans, "screening.plan")[0])
        fix = _named(spans, "screening.fixpoint")[0]
        assert st["t_fixpoint"] == _sec(fix)
        assert fix["counters"]["sweeps"] == st["sweeps"]
        assert fix["counters"]["swept_tiles"] == st["swept_tiles"]


MESH_COUNTERS = ("rows_max", "matrix_bytes_max", "tiles_max_over_mean")


@pytest.mark.parametrize("k", [0, 2, 3])
def test_mesh_spans_on_a_cpu_mesh_and_none_without(k):
    """On a mesh of k CPU devices each stage plans in ``mesh.plan`` spans
    whose ``rows_max`` is at most ceil(nrb / k) and whose largest
    ``matrix_bytes_max`` is the float32 bounds of the largest deal; every
    merge is a ``mesh.merge`` span counting the bytes it copied, and the
    stage spans count ``tiles_max_over_mean`` (at least 1). Without a
    mesh (k = 0) no such span or counter exists."""
    from clustering_tpu_torch.parallel import make_mesh
    coords = _golden_coords()
    mesh = make_mesh(devices=["cpu"] * k) if k else None

    def run():
        eng = tengine.DensityEngine(coords, RB, CB, device="cpu", mesh=mesh)
        fe = tdops.free_energies(eng.populations([0.2])[0.2])
        nh_d2 = eng.nearest_neighbors(fe, tier_qs=(0.5, 0.9))[1]
        order = np.argsort(fe, kind="stable")
        tscreening.ScreeningEngine(coords[order], RB, CB, device="cpu",
                                   mesh=mesh).run(
            np.arange(len(coords), dtype=np.int32), len(coords) * 3 // 4,
            np.float32(4.0 * np.mean(nh_d2)))
        return eng
    eng, spans = _spans_since(run)
    plans, merges = _named(spans, "mesh.plan"), _named(spans, "mesh.merge")
    counted = [s for s in spans if set(MESH_COUNTERS) & set(s["counters"])]
    if not k:
        assert not plans and not merges and not counted
        return
    nrb, ncb = eng.n_pad // RB, eng.n_pad // CB
    most = -(-nrb // k)
    assert {_parent_name(spans, s) for s in plans} >= {
        "populations.best_sort", "populations.radius_masks", "nn.plan",
        "nn.band", "screening.plan"}
    assert all(s["counters"]["rows_max"] <= most for s in plans)
    assert max(s["counters"]["matrix_bytes_max"] for s in plans) \
        == most * ncb * 4
    assert merges and all(s["counters"]["bytes"] > 0 for s in merges)
    skews = {s["name"]: s["counters"]["tiles_max_over_mean"] for s in spans
             if "tiles_max_over_mean" in s["counters"]}
    assert set(skews) == {"populations.sweep", "nn.band", "nn.phase2",
                          "screening.fixpoint"}
    assert all(1.0 <= v <= k for v in skews.values())


def test_screener_build_spans_on_the_calling_thread():
    """Built through the API, the screener's spans run on the caller's
    thread under the same names, ``build_seconds`` the build's; without
    an order handed in it computes the Morton order itself."""
    coords = _golden_coords()
    fe = np.linspace(0.0, 2.0, len(coords)).astype(np.float32)
    series, spans = _spans_since(lambda: tscreening.ThresholdSeriesScreener(
        coords, fe, [0.5, 1.0], RB, CB, device="cpu"))
    build = _named(spans, "screener.build")
    assert len(build) == 1 and build[0]["thread"] == MAIN
    assert series.build_seconds == _sec(build[0])
    kids = {s["name"] for s in spans if s["parent"] == build[0]["id"]}
    assert kids == {"screener.morton", "screener.sort", "screener.fe_sort",
                    "screener.gather", "screener.upload"}
    assert build[0]["counters"]["morton_reused"] == 0


def test_device_warm_span_on_its_thread():
    """The CLI's device warm runs in a ``cli.device_warm`` span on thread
    "device-warm", under the span open where it starts; on a build
    without CUDA it ends in an error, which the sub-stage line leaves
    out."""
    timer.reset()
    with timer.span("cli.start") as start:
        thread = tcli._start_device_warm(torch.device("cpu"))
    thread.join()
    warm = [s.as_dict() for s in timer.finished("cli.device_warm")]
    assert len(warm) == 1
    assert warm[0]["thread"] == "device-warm"
    assert warm[0]["parent"] == start.id
    if not torch.cuda.is_available():
        assert "error" in warm[0]["args"]
        assert tdensity._device_warm_seconds() is None


def test_no_spans_line_without_the_switch(tmp_path):
    """Without CLUSTERING_TPU_PROFILE_SUBSTAGES the log has no spans line
    (and no sub-stage line); its stage lines are there."""
    log = _run_cli(tmp_path, {})
    assert "[spans]" not in log and "substages:" not in log
    assert "[populations: " in log and "[screening 1.20: " in log


def test_the_buffer_stays_bounded_over_many_library_calls():
    """A warm library process keeps the last ``LIMIT`` spans; the line
    counts the rest as dropped."""
    timer.reset()
    eng = tengine.DensityEngine(_golden_coords()[:40], RB, CB, device="cpu")
    while len(timer.finished()) < timer.LIMIT:
        eng.populations([0.2])
    for _ in range(20):
        eng.populations([0.2])
    assert len(timer.finished()) == timer.LIMIT
    line = json.loads(timer.line()[len("[spans] "):])
    assert len(line["spans"]) == timer.LIMIT and line["dropped"] > 0
    timer.reset()
    assert timer.finished() == []


def test_spans_from_many_threads_are_all_counted():
    """Threads recording at once, more than the cores, with the
    interpreter switching often: every span is kept or counted as
    dropped, ids are unique, and each thread's counters and parents are
    its own."""
    import threading
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 700
    timer.reset()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            with timer.span(f"outer{k}"):
                for _ in range(per_thread - 1):
                    with timer.span("inner"):
                        timer.count("n")
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    line = json.loads(timer.line()[len("[spans] "):])
    assert len(line["spans"]) == timer.LIMIT
    assert len(line["spans"]) + line["dropped"] == n_threads * per_thread
    assert len({s["id"] for s in line["spans"]}) == timer.LIMIT
    outer = {s["id"]: s["thread"] for s in line["spans"]
             if s["name"].startswith("outer")}
    for s in line["spans"]:
        if s["name"] == "inner":
            assert s["counters"] == {"n": 1}
            if s["parent"] in outer:
                assert outer[s["parent"]] == s["thread"]
    timer.reset()


def test_pending_counts_are_summed_when_settled_or_exported():
    """``count_pending`` keeps a tensor on the innermost span and adds
    its sum when the span settles; the export settles what is left; with
    no span open it does nothing."""
    timer.reset()
    timer.count_pending("lost", torch.ones(3, dtype=torch.int64))
    buf = torch.zeros(4, dtype=torch.int64)
    with timer.span("sweep") as sweep:
        timer.count("launches")
        timer.count_pending("steps", buf)
        timer.count_pending("steps", buf[:2])
    buf += 5  # the queued work's writes land before the settle
    sweep.settle()
    assert sweep.counters == {"launches": 1, "steps": 30}
    sweep.settle()
    assert sweep.counters["steps"] == 30
    with timer.span("warm"):
        timer.count_pending("steps", torch.full((2,), 7))
    line = json.loads(timer.line()[len("[spans] "):])
    assert [s["counters"] for s in line["spans"]] == [
        {"launches": 1, "steps": 30}, {"steps": 14}]
    timer.reset()


def test_bench_log_readers_ignore_the_spans_line(cli_log):
    """The benchmark's ``stages.measured`` reads the same from the log
    with and without the spans line."""
    bare = "\n".join(ln for ln in cli_log.splitlines()
                     if not ln.startswith("[spans] ")) + "\n"
    assert bare != cli_log
    got = stages.measured(cli_log, 9.0)
    assert got == stages.measured(bare, 9.0)
    assert got["populations"] is not None and got["nn_tiles"] is not None
    assert stages.stage_names(cli_log) == stages.stage_names(bare)


def test_profiled_cli_holds_every_span_on_the_trace_clock(tmp_path):
    """A profiled CLI process (CLUSTERING_TPU_PROFILE): every span opened
    while the profile recorded is an annotation of its name on its own
    thread in trace.json -- ``screener.build`` on a write-pool thread
    among them -- whose start, ``baseTimeNanoseconds + 1000 ts``, lies
    inside the span (to the clocks' 1 ms), and within 1 ms of the span's
    start for nine spans in ten and at the median. A thread that the host stalls between the
    span's clock and the annotation's shows a larger gap (4-7 ms, in
    about one run in four on a busy machine) but stays inside its
    span."""
    np.savetxt(tmp_path / "coords.dat", _golden_coords(), fmt="%.6f")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               CLUSTERING_TORCH_DEVICE="cpu",
               CLUSTERING_TPU_PROFILE=str(tmp_path / "trace"),
               CLUSTERING_TPU_PROFILE_SUBSTAGES="1")
    proc = subprocess.run([sys.executable, "-m", "clustering_tpu_torch"]
                          + ARGV, cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    spans = _spans_of(proc.stdout)
    with open(tmp_path / "trace" / "trace.json") as fh:
        trace = json.load(fh)
    base = trace["baseTimeNanoseconds"]
    notes = [e for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    main_tid = _named(spans, "populations")[0]["tid"]
    build = _named(spans, "screener.build")[0]
    assert build["thread"].startswith("write_") and build["tid"] != main_tid
    # cli.start and cli.imports open before the profile starts
    later = [s for s in spans if s["name"] not in ("cli.start",
                                                   "cli.imports")]
    assert len(later) > 30
    assert {s["thread"][:5] for s in later} >= {"MainT", "write", "post_",
                                                "io_0"}
    gaps = []
    for s in later:
        starts = [base + 1000 * e["ts"] for e in notes
                  if e["name"] == s["name"] and e["tid"] == s["tid"]]
        assert starts, s
        ann = min(starts, key=lambda t: abs(t - s["start_ns"]))
        assert s["start_ns"] - 1e6 < ann < s["end_ns"] + 1e6, s
        gaps.append(abs(ann - s["start_ns"]))
    gaps.sort()
    assert gaps[len(gaps) // 2] < 1e6, gaps
    assert gaps[int(0.9 * len(gaps)) - 1] < 1e6, gaps
