"""Probe of the port's spans on the ``cli-10m`` cell's input: cold CLI
jobs with the spans line on and off in turns
(``CLUSTERING_TPU_PROFILE_SUBSTAGES``), then one job under the profiler
whose trace is read here: its idle gaps named by the innermost annotation
of any thread, kernels against the spans they ran in, each annotation's
start against its span's, the stage that set the device peak. Writes
``--out`` (default ``build/spans_probe_<seed>.json``: each job's stage
walls, the span tree with each span's CPU share, the span metrics'
readings) and prints a summary.

    python3 spans_probe.py --seed N [--turns K] [--out PATH]
                           [--frames N --device cpu]

``--frames`` and ``--device cpu`` rehearse it small on a machine without
a card (with ``CLUSTERING_TORCH_DEVICE=cpu`` in the environment).
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from bench_port import run as brun  # noqa: E402
from bench_port import spans as bspans  # noqa: E402
from bench_port import spec as specs  # noqa: E402
from bench_port import stages  # noqa: E402
from bench_port import trace as btrace  # noqa: E402
from bench_port.entries import cli as ecli  # noqa: E402

METRICS = ["cli.start_s", "io.read_s", "io.write_wait_s", "screening.build_s",
           "nn.phase2_tiles", "cli.unspanned_s", "cli.outside_stages_s",
           "populations.best_sort_s", "screening.setup_s", "nn.tiles",
           "populations.wall_s", "nn.wall_s", "screening.wall_s"]


def launch(run, k, extra, substages=True):
    d = os.path.join(run.dir, f"p{k}")
    os.makedirs(d)
    env = ecli._env(run, extra)
    if not substages:
        env.pop(ecli.SUBSTAGES_ENV)
    with open(os.path.join(d, "out"), "wb") as out, \
            open(os.path.join(d, "err"), "wb") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "bench_port.cli_job"]
                                + ecli.argv(run), cwd=d, env=env,
                                stdout=out, stderr=err)
        _, status, usage = os.wait4(proc.pid, 0)
        wall = time.perf_counter() - t0
    log = open(os.path.join(d, "out")).read()
    rc = os.waitstatus_to_exitcode(status)
    if rc:
        print(open(os.path.join(d, "err")).read()[-3000:], file=sys.stderr)
    return {"wall": wall, "rc": rc, "log": log, "dir": d,
            "measured": dict(stages.measured(log, wall),
                             maxrss=usage.ru_maxrss * 1024)}


def tree(spans):
    by_id = {s["id"]: s for s in spans}
    out = []
    for s in sorted(spans, key=lambda s: s["start_ns"]):
        wall = (s["end_ns"] - s["start_ns"]) / 1e9
        p = by_id.get(s["parent"])
        out.append({"name": s["name"], "thread": s["thread"],
                    "parent": None if p is None else p["name"],
                    "t0_s": round((s["start_ns"] - spans_t0(spans)) / 1e9, 4),
                    "wall_s": round(wall, 4),
                    "cpu_share": round(s["cpu_ns"] / 1e9 / wall, 3)
                    if wall > 0 else None,
                    "counters": s["counters"], "args": s["args"]})
    return out


def spans_t0(spans):
    return min(s["start_ns"] for s in spans)


def analyse_trace(path, log, spans):
    with open(path) as fh:
        data = json.load(fh)
    base = data.get("baseTimeNanoseconds", 0)
    events = data["traceEvents"]
    summary = btrace.summarize(events, set(stages.stage_names(log)))
    notes = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("ph") == "X"]
    threads_with_notes = sorted({e["tid"] for e in notes})
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("ph") == "X"]
    main = [s for s in spans if s["thread"] == "MainThread"]

    def inside(kname, sname):
        sp = [s for s in main if s["name"] == sname]
        ks = [e for e in kernels if kname in e["name"]]
        rows = []
        for s in sp:
            for e in ks:
                a = base + 1000 * e["ts"]
                b = a + 1000 * e["dur"]
                if s["start_ns"] - 1e9 < a < s["end_ns"] + 1e9:
                    rows.append({"kernel": e["name"][:60], "span": sname,
                                 "kernel_ns": [int(a), int(b)],
                                 "span_ns": [s["start_ns"], s["end_ns"]],
                                 "inside": s["start_ns"] <= a
                                 and b <= s["end_ns"],
                                 "margins_ms": [(a - s["start_ns"]) / 1e6,
                                                (s["end_ns"] - b) / 1e6]})
        return rows
    checks = (inside("pops_bidir", "populations")
              + inside("pops_bidir", "populations.sweep")
              + inside("nn_bidir", "nearest neighbors")
              + inside("label_min_bidir", "screening 0.50"))
    # each span's annotation start against the span's start
    gaps = []
    for s in spans:
        starts = [base + 1000 * e["ts"] for e in notes
                  if e["name"] == s["name"] and e["tid"] == s["tid"]]
        if starts:
            gaps.append(min(abs(t - s["start_ns"]) for t in starts) / 1e6)
    gaps.sort()
    return {"summary": None if summary is None else
            {k: v for k, v in summary.items() if k != "kernels"},
            "annotated_threads": len(threads_with_notes),
            "annotations": len(notes),
            "kernel_in_span": checks[:12],
            "annotation_gap_ms": {"n": len(gaps),
                                  "median": gaps[len(gaps) // 2]
                                  if gaps else None,
                                  "p90": gaps[int(0.9 * len(gaps)) - 1]
                                  if gaps else None,
                                  "max": gaps[-1] if gaps else None},
            "trace_bytes": os.path.getsize(path)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--frames", type=int)
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args()
    if args.frames:
        config = specs.config
        specs.config = lambda name, **kw: dict(config(name, **kw),
                                               n_frames=args.frames)
    spec = specs.benchmark()
    cell = specs.cell(spec, "cli-10m")
    run = brun.make_run(cell, args.seed, 51, args.device)
    ecli.prepare(run)
    res = {"seed": args.seed, "n": len(run.coords)}
    jobs = {"on": [], "off": []}
    for t in range(args.turns):
        order = ("on", "off") if t % 2 == 0 else ("off", "on")
        for kind in order:
            rec = launch(run, f"{kind}{t}", {}, substages=kind == "on")
            assert rec["rc"] == 0, kind
            jobs[kind].append(rec)
            print(f"job {kind} {rec['wall']:.3f}s", flush=True)
    for kind in jobs:
        res[kind] = {"walls": [r["wall"] for r in jobs[kind]],
                     "stage_walls": [stages.walls(r["log"])
                                     for r in jobs[kind]]}
    from types import SimpleNamespace
    ctx = SimpleNamespace(jobs=jobs["on"])
    res["metrics_on_jobs"] = {m: specs.metric_reader(m)(ctx)
                              for m in METRICS}
    first = bspans.of_log(jobs["on"][0]["log"])
    res["tree_untraced"] = tree(first)
    res["line_bytes"] = [len(ln) for ln in jobs["on"][0]["log"].splitlines()
                         if ln.startswith("[spans] ")]
    # the traced job
    trace_dir = os.path.join(run.dir, "profile")
    rec = launch(run, "traced", {ecli.PROFILE_ENV: trace_dir})
    assert rec["rc"] == 0
    tspans = bspans.of_log(rec["log"])
    res["traced"] = {"wall": rec["wall"],
                     "stage_walls": stages.walls(rec["log"]),
                     "substages": stages.substages(rec["log"]),
                     "tree": tree(tspans)}
    res["traced"].update(analyse_trace(os.path.join(trace_dir,
                                                    "trace.json"),
                                       rec["log"], tspans))
    peaks = [(s["name"], s["counters"].get("peak_device_bytes"))
             for s in sorted(first, key=lambda s: s["start_ns"])
             if s["parent"] is None and s["thread"] == "MainThread"]
    res["peaks_by_root"] = peaks
    top = max((v or 0) for _, v in peaks)
    res["peak_set_by"] = next((n for n, v in peaks if v == top), None)
    out = args.out or os.path.join(ROOT, "build",
                                   f"spans_probe_{args.seed}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(res, fh, indent=1, default=str)
    brief = {"on": res["on"]["walls"], "off": res["off"]["walls"],
             "traced": rec["wall"], "metrics": res["metrics_on_jobs"],
             "peak_set_by": res["peak_set_by"],
             "gaps": (res["traced"]["summary"] or {}).get("idle_gaps"),
             "annotated_threads": res["traced"]["annotated_threads"],
             "annotation_gap_ms": res["traced"]["annotation_gap_ms"],
             "kernel_in_span": [(c["kernel"][:30], c["span"], c["inside"],
                                 [round(m, 3) for m in c["margins_ms"]])
                                for c in res["traced"]["kernel_in_span"]]}
    print(json.dumps(brief, indent=1, default=str))


if __name__ == "__main__":
    main()
