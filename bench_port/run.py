"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

1. Set-up: the cell's frames from ``--seed`` (``fel.py``), and what the
   cell's entry needs before its first job (``entries/<entry>.py``).
2. The window: jobs back to back until their walls add up to
   ``--seconds``; the job in flight then is finished and counted. Work
   the harness does between jobs (fingerprinting a job's files) is not in
   the window. With ``--trace 1`` one more job runs under the profiler
   after the window, for the metrics that read a trace.
3. The check, once the window has closed and the jobs' memory has been
   read: the plain reference (a sample of frames drawn from the seed, and
   the clustering of every threshold over all frames) and the comparison
   of ``check.py``, whose numbers and limits are the last lines on
   standard error and the last key of the result line.

The result line is the last line on standard output. The run fails with
no result line where no CUDA device is visible, or fewer than the cell
asks for, or where JAX or the JAX package ``clustering_tpu`` has been
loaded into this process or a job's.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_port import check, fel, spec as specs  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "clustering_tpu")


class RunFailed(Exception):
    """A run that prints no result line."""


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``clustering_tpu_torch`` is not ``clustering_tpu``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def device_info(chips):
    """The card's name, count and power limit; RunFailed without enough
    CUDA devices (no fallback to the CPU)."""
    if not torch.cuda.is_available():
        raise RunFailed("no CUDA device is available")
    count = torch.cuda.device_count()
    if count < chips:
        raise RunFailed(f"the cell asks for {chips} devices, {count} seen")
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        info["power_limit_W"] = float(smi.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return info


def sample_rows(seed, n, size, extra=()):
    """``size`` distinct frames drawn from the seed, plus ``extra``."""
    rng = np.random.default_rng(fel.seed_words(seed, 1))
    rows = rng.choice(n, size=min(size, n), replace=False)
    return np.unique(np.concatenate([rows, np.asarray(extra, np.int64)]))


def make_run(cell, seed, seconds, device="cuda"):
    t0 = time.perf_counter()
    cfg = specs.config(cell["config"])
    traffic = specs.traffic(cell["traffic"])
    x = fel.synthetic_fel(cfg["n_frames"], cfg["dim"], fel.seed_words(seed))
    q = fel.micro_units(x)
    del x
    return SimpleNamespace(
        cell=cell, config=cfg, traffic=traffic, seed=seed, seconds=seconds,
        device=device, root=specs.ROOT,
        dir=tempfile.mkdtemp(prefix="bench_port."), q=q,
        coords=fel.coords_f32(q), entry=specs.entry(traffic["entry"]),
        setup_parts={"start": t0 - T0, "frames": time.perf_counter() - t0})


def window(run):
    """Jobs back to back until their walls reach ``run.seconds``."""
    jobs = []
    spent = 0.0
    while spent < run.seconds:
        rec = run.entry.job(run, len(jobs))
        run.entry.finish(run, rec, first=not jobs)
        jobs.append(rec)
        spent += rec["wall"]
        if rec["rc"] != 0:
            break
    return jobs


class Reference:
    """The plain reference of a run, worked out from its frames alone.

    ``answers`` are the sweep's for ``rows``, a sample of frames drawn
    from the seed with the frame of the largest population of the first
    job's outputs ``out0``; those outputs' populations decide which
    neighbours count as of higher density (``pops_of`` holds the ones the
    comparison relies on to the reference's own). ``pair_d2`` gives the
    d2 of frame pairs, ``pops_of`` the populations of frames, and
    ``clusterings`` the components of each threshold's frames, each
    worked out once."""

    def __init__(self, run, out0, control=False):
        dev = "cuda" if run.device == "cuda" and torch.cuda.is_available() \
            else "cpu"
        self.mod = specs.reference(run.config["reference"])
        self.merge = specs.reference("merge")
        self.radius = run.config["radius"]
        self.coords = torch.as_tensor(run.coords, device=dev)
        self.rows = sample_rows(run.seed, len(run.coords),
                                run.config["sample_frames"],
                                extra=[int(np.argmax(out0["pops"]))])
        self.answers = self.mod.sweep(
            self.coords, torch.as_tensor(self.rows, device=dev),
            self.radius,
            torch.as_tensor(np.asarray(out0["pops"], np.int64)),
            control=control)
        self._pops = dict(zip(self.rows.tolist(),
                              self.answers["pop"].tolist()))
        self._components = {}

    def _ids(self, ids):
        return torch.as_tensor(np.asarray(ids, np.int64),
                               device=self.coords.device)

    def pair_d2(self, i, j):
        return self.mod.pair_sq_dists(self.coords, self._ids(i),
                                      self._ids(j)).cpu().numpy()

    def pops_of(self, frames):
        frames = np.asarray(frames, np.int64)
        new = np.asarray(sorted({int(f) for f in frames} - set(self._pops)),
                         np.int64)
        if len(new):
            got = self.mod.populations(self.coords, self._ids(new),
                                       self.radius)
            self._pops.update(zip(new.tolist(), got.tolist()))
        return np.asarray([self._pops[int(f)] for f in frames], np.int64)

    def clusterings(self, levels, n_levels, link2):
        key = (levels.tobytes(), n_levels, link2)
        if key not in self._components:
            self._components = {key: self.merge.clusterings(
                self.coords, self._ids(levels), n_levels, link2)}
        return self._components[key]


def judge(run, jobs):
    """(numbers, limits) of the comparison with the reference."""
    ref = Reference(run, run.entry.outputs(run, jobs[0]))
    thresholds = run.entry.thresholds(run)
    readings = [check.judge(out, ref, thresholds, rank=out.get("rank"))
                for out in (run.entry.outputs(run, rec)
                            for rec in run.entry.judged(run, jobs))]
    numbers = check.worst(readings)
    numbers.update(run.entry.agreement(run, jobs))
    numbers["jobs_failed"] = sum(rec["rc"] != 0 for rec in jobs)
    limits = dict(run.traffic["limits"], jobs_failed=0)
    return numbers, limits


def read_metrics(spec, run, kind, ctx):
    out = {}
    for m in specs.metrics_of(spec, run.cell["name"], kind):
        value = specs.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(spec, cell, seed, seconds, trace, device="cuda",
             check_device=True):
    """Run the cell; returns the result dict (RunFailed: no result)."""
    info = (device_info(cell["chips"]) if check_device
            else {"platform": device, "kind": device, "count": 1})
    run = make_run(cell, seed, seconds, device)
    try:
        run.entry.prepare(run)
        setup_s = time.perf_counter() - T0
        jobs = window(run)
        traced, summary = None, None
        if trace and jobs[-1]["rc"] == 0:
            traced, summary = run.entry.traced_job(run)
        done = jobs + ([traced] if traced is not None else [])
        for rec in done:
            if rec.get("forbidden"):
                raise RunFailed("a job loaded " + ", ".join(rec["forbidden"]))
        info["memory_peak_bytes"] = max(rec.get("peak_reserved", 0)
                                        for rec in done)
        run.entry.release(run)
        t_check = time.perf_counter()
        numbers = {"jobs_failed": sum(rec["rc"] != 0 for rec in done)}
        limits = {"jobs_failed": 0}
        if not numbers["jobs_failed"]:
            try:
                numbers, limits = judge(run, done)
            except (OSError, ValueError) as exc:
                sys.stderr.write(f"bench_port: unreadable outputs: {exc}\n")
                numbers["outputs_unreadable"] = 1
                limits["outputs_unreadable"] = 0
        ok, rows = check.verdict(numbers, limits)
        ctx = SimpleNamespace(
            jobs=jobs, trace=summary,
            n=len(run.coords), dim=run.coords.shape[1], setup_s=setup_s,
            pops_sum=run.entry.pops_sum(run, jobs[0]))
        kind = "per_layer" if trace else "end_to_end"
        result = {"correct": ok, "attempted": len(done),
                  "failed": sum(rec["rc"] != 0 for rec in done),
                  "metrics": read_metrics(spec, run, kind, ctx),
                  "device": info}
        if summary is not None:
            info["busy_s"] = summary["busy_s"]
            info["window_s"] = summary["window_s"]
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
        result["checks"] = {name: {"value": v, "limit": lim}
                            for name, v, lim in rows}
        sys.stderr.write(
            f"bench_port: setup {setup_s:.3f}s "
            f"{ {k: round(v, 3) for k, v in run.setup_parts.items()} }, "
            f"job walls "
            f"{[round(rec['wall'], 3) for rec in done]}, check "
            f"{time.perf_counter() - t_check:.3f}s\n")
        for rec in done:
            if rec["rc"] != 0:
                sys.stderr.write(rec.get("tail", "") + "\n")
        for name, v, lim in rows:
            sys.stderr.write(f"check {name} {v!r} limit {lim!r}\n")
        return result
    finally:
        shutil.rmtree(run.dir, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = specs.benchmark()
    try:
        result = run_cell(spec, specs.cell(spec, args.workload), args.seed,
                          args.seconds, args.trace)
    except RunFailed as exc:
        print(f"bench_port: {exc}", file=sys.stderr)
        return 1
    found = forbidden_modules()
    if found:
        print("bench_port: loaded " + ", ".join(found), file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
