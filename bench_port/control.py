"""The control of ``correct``, and the readings that its limits are set
from: ``python -m bench_port.control --workload <cell> --seeds 3 4 5``.

For each seed it builds the cell's input, runs one job of the cell's entry
(a window of one job), and judges it as a run does by the ``density``
comparison (``program``; a cell whose traffic names another comparison
has no control here); then it
puts the reference, computed with coordinates and arithmetic in bfloat16,
the precision below the configuration's float32, in the program's place
at the sampled frames (``control``: its populations, free energies and
both neighbour pairs; the clusterings stay the program's) and judges that.
One JSON line per seed. A sound program reads within every limit; the
control has to read above one of them. The benchmark's runs do not run
this.
"""

import argparse
import json
import shutil
import sys

import numpy as np

from bench_port import run as runs, spec as specs
from bench_port.checks import density


def with_answers(out, rows, answers):
    """``out`` with the answers at ``rows`` replaced by ``answers`` (a
    reference sweep's dict)."""
    out = dict(out)
    pops = np.asarray(out["pops"], dtype=np.int64).copy()
    pops[rows] = answers["pop"]
    out["pops"] = pops
    fe = np.asarray(out["fe"], dtype=np.float64).copy()
    fe[rows] = density.free_energy32(pops)[rows]
    out["fe"] = fe
    for kind in ("nh", "hd"):
        ids = np.asarray(out[kind + "_id"], dtype=np.int64).copy()
        d2 = np.asarray(out[kind + "_d2"], dtype=np.float64).copy()
        none = ~np.isfinite(answers[kind + "_d2"])
        ids[rows] = np.where(none, 0, answers[kind + "_id"])
        d2[rows] = np.where(none, 0.0, answers[kind + "_d2"])
        out[kind + "_id"], out[kind + "_d2"] = ids, d2
    return out


def readings(cell, seed, device="cuda"):
    """{"program": numbers, "control": numbers, "job_s": the job's wall}
    of one seed."""
    run = runs.make_run(cell, seed, 0, device)
    try:
        run.entry.prepare(run)
        rec = run.entry.job(run, 0)
        run.entry.finish(run, rec, first=True)
        run.entry.release(run)
        if rec["rc"] != 0:
            raise RuntimeError("the job failed:\n" + rec.get("tail", ""))
        out = density.outputs(run, rec)
        ref = density.Reference(run, out, control=True)
        thresholds = run.entry.thresholds(run)
        rank = out.get("rank")
        return {"program": density.compare(out, ref, thresholds, rank),
                "control": density.compare(
                    with_answers(out, ref.rows, ref.answers["control"]),
                    ref, thresholds, rank),
                "job_s": rec["wall"]}
    finally:
        shutil.rmtree(run.dir, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    spec = specs.benchmark()
    cell = specs.cell(spec, args.workload)
    runs.device_info(cell["chips"])
    for seed in args.seeds:
        print(json.dumps(dict(readings(cell, seed), seed=seed,
                              workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
