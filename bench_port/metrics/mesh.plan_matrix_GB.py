"""mesh.plan_matrix_GB: the largest block-pair matrix that one device of
the mesh allocated while planning, in 1e9 bytes: the largest
``matrix_bytes_max`` counter of a CLI job's ``mesh.plan`` spans, the
largest over the window's jobs. None where no span has the counter."""

from bench_port import spans

COUNTER = "matrix_bytes_max"


def _largest(job_spans, job):
    vals = [s["counters"][COUNTER] for s in job_spans
            if s["name"] == "mesh.plan" and COUNTER in s["counters"]]
    return max(vals) if vals else None


def read(ctx):
    vals = []
    for job in ctx.jobs:
        job_spans = spans.of_log(job.get("log", ""))
        val = None if job_spans is None else _largest(job_spans, job)
        if val is None:
            return None
        vals.append(val)
    return max(vals) / 1e9 if vals else None
