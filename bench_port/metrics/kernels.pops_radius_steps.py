"""kernels.pops_radius_steps: the ``pops_bidir.radius_steps`` counter of a
CLI job's ``populations.sweep`` span (main thread): the (warp, step,
radius) triples whose count the counting kernel ran, where a warp skips
each radius that none of a step's pairs reaches. Only the launches of
several radii count it. The same for every job of a seed; mean over the
window's jobs; None where a job's span has no such counter (a program
whose kernel computes every radius in every step)."""

from bench_port import spans

SPAN = "populations.sweep"
COUNTER = "pops_bidir.radius_steps"


def _radius_steps(job_spans, job):
    vals = [s["counters"][COUNTER] for s in job_spans
            if s["name"] == SPAN and s["thread"] == spans.MAIN
            and COUNTER in s["counters"]]
    return sum(vals) if vals else None


def read(ctx):
    return spans.job_mean(ctx.jobs, _radius_steps)
