"""mesh.tile_skew: the largest ``tiles_max_over_mean`` counter of a CLI
job's main-thread spans (populations, the NN band and phase 2, each
screening fixpoint): the most tiles one device of the mesh swept in a
stage over the mean of its devices; mean over the window's jobs. 1 is a
perfect balance. None where no span has the counter."""

from bench_port import spans

COUNTER = "tiles_max_over_mean"


def _largest(job_spans, job):
    vals = [s["counters"][COUNTER] for s in job_spans
            if s["thread"] == spans.MAIN and COUNTER in s["counters"]]
    return max(vals) if vals else None


def read(ctx):
    return spans.job_mean(ctx.jobs, _largest)
