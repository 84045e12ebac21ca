"""The ``cli`` entry: one job is one cold process of the density CLI.

Set-up writes the frames as ``%.6f`` text and builds what the CLI builds
at first use. A job is
``python -m bench_port.cli_job density -f coords.dat -r R -p pop -d fe
-b nn -o clust -T FROM STEP TO -v`` in a fresh directory of its own under
``TMPDIR``, with the CLI's defaults and ``CLUSTERING_TPU_PROFILE_SUBSTAGES``
set. It is timed on the harness's clock from spawn to exit, since users
run the CLI as a cold process, and its peak RSS is its own rusage
(``os.wait4``). Every job reads the same file, so every job's output
files must be the first job's byte for byte below their headers; each
later job's files are fingerprinted and deleted as it ends, and only the
first job's are parsed and judged. The traced job runs under
``CLUSTERING_TPU_PROFILE``, the CLI's whole-run trace.
"""

import json
import os
import subprocess
import sys
import time

from .. import check, fel, stages, textfiles
from .. import trace as traces

INPUT = "coords.dat"
PROFILE_ENV = "CLUSTERING_TPU_PROFILE"
SUBSTAGES_ENV = "CLUSTERING_TPU_PROFILE_SUBSTAGES"
MARK = "bench_port.cli_job "
TAIL = 4000


def _env(run, extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [run.root] + [p for p in [env.get("PYTHONPATH")] if p])
    env[SUBSTAGES_ENV] = "1"
    env.update(extra or {})
    return env


def _files(run):
    return ["pop", "fe", "nn"] + [f"clust.{float(t):.2f}"
                                  for t in thresholds(run)]


def thresholds(run):
    return check.threshold_series(*map(float, run.traffic["thresholds"]))


def argv(run):
    return (["density", "-f", os.path.join(run.dir, INPUT), "-r",
             str(run.config["radius"]), "-p", "pop", "-d", "fe", "-b", "nn",
             "-o", "clust", "-T"] + [str(t) for t in run.traffic["thresholds"]]
            + ["-v"])


def prepare(run):
    """Write the input text; build what the CLI builds at first use (the
    CUDA kernel library into ``build/torch_kernels/`` where a card is
    visible, the native text codec), so that no job of the window
    compiles. Building loads no CUDA context into this process."""
    t0 = time.perf_counter()
    fel.write_text(os.path.join(run.dir, INPUT), run.q)
    t1 = time.perf_counter()
    import torch
    from clustering_tpu_torch.ops import _build
    from clustering_tpu_torch.utils import textio_native
    if torch.cuda.is_available():
        _build.build()
    textio_native.available()
    run.setup_parts.update(text=t1 - t0, build=time.perf_counter() - t1)


def job(run, k, extra_env=None):
    """Run job ``k``; its record: ``wall``, ``rc``, ``log`` (standard
    output), ``tail`` (the end of standard error), ``peak_allocated``,
    ``peak_reserved``, ``forbidden``, ``dir`` and ``measured``: the stage
    walls and counters of its log (``stages.measured``) and ``maxrss``,
    its peak RSS in bytes."""
    d = os.path.join(run.dir, f"job{k}")
    os.makedirs(d)
    out_path, err_path = os.path.join(d, "stdout"), os.path.join(d, "stderr")
    with open(out_path, "wb") as out, open(err_path, "wb") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "bench_port.cli_job"] + argv(run),
            cwd=d, env=_env(run, extra_env), stdout=out, stderr=err)
        _, status, usage = os.wait4(proc.pid, 0)
        wall = time.perf_counter() - t0
    proc.returncode = os.waitstatus_to_exitcode(status)
    with open(out_path) as fh:
        log = fh.read()
    with open(err_path) as fh:
        tail = fh.read()[-TAIL:]
    rec = {"wall": wall, "rc": proc.returncode, "log": log, "tail": tail,
           "dir": d, "forbidden": [],
           "measured": dict(stages.measured(log, wall),
                            maxrss=usage.ru_maxrss * 1024)}
    for line in log.splitlines():
        if line.startswith(MARK):
            mark = json.loads(line[len(MARK):])
            rec.update(peak_allocated=mark["peak_allocated"],
                       peak_reserved=mark["peak_reserved"],
                       forbidden=mark["forbidden"])
    return rec


def finish(run, rec, first):
    """Fingerprint the job's files; delete a later job's files."""
    rec["digests"] = {}
    for name in _files(run):
        path = os.path.join(rec["dir"], name)
        if os.path.exists(path):
            rec["digests"][name] = textfiles.body_digest(path)
            if not first:
                os.remove(path)


def traced_job(run):
    """The job under the CLI's profiler: (its record, the trace's
    summary)."""
    trace_dir = os.path.join(run.dir, "profile")
    rec = job(run, "traced", {PROFILE_ENV: trace_dir})
    finish(run, rec, first=False)
    summary = None
    path = os.path.join(trace_dir, "trace.json")
    if rec["rc"] == 0 and os.path.exists(path):
        summary = traces.summarize(traces.load(path),
                                   set(stages.stage_names(rec["log"])))
        os.remove(path)
    return rec, summary


def release(run):
    """Nothing: the jobs' processes have ended."""


def _device(run):
    import torch
    return "cuda" if run.device == "cuda" and torch.cuda.is_available() \
        else "cpu"


def outputs(run, rec):
    """The job's files as arrays (parsed once)."""
    if "out" not in rec:
        dev = _device(run)

        def col(name, n_cols=1):
            return textfiles.read_table(os.path.join(rec["dir"], name),
                                        n_cols, dev)
        nn = col("nn", 4)
        rec["out"] = {
            "pops": col("pop")[:, 0].astype("int64"),
            "fe": col("fe")[:, 0],
            "nh_id": nn[:, 0].astype("int64"), "nh_d2": nn[:, 1],
            "hd_id": nn[:, 2].astype("int64"), "hd_d2": nn[:, 3],
            "clust": [col(name)[:, 0].astype("int64")
                      for name in _files(run)[3:]],
        }
    return rec["out"]


def judged(run, jobs):
    """Only the first job's files are parsed: the others must equal
    them."""
    return jobs[:1]


def agreement(run, jobs):
    """``jobs_differ``: jobs whose files differ from the first job's."""
    first = jobs[0]["digests"]
    return {"jobs_differ": sum(rec["digests"] != first or len(first)
                               != len(_files(run)) for rec in jobs[1:])}


def pops_sum(run, rec):
    out = rec.get("out")
    return None if out is None else int(out["pops"].sum())
