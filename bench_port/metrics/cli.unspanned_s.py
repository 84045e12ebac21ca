"""cli.unspanned_s: a CLI job's wall (spawn to exit, on the harness's
clock) less the union of its main thread's spans: what the spans leave
unnamed, the spawn and the interpreter's and CUDA's exit among it, mean
over the window's jobs."""

from bench_port import spans


def read(ctx):
    return spans.job_mean(ctx.jobs, lambda s, job: job["wall"]
                          - spans.covered_s(s))
