"""io.read_s: a CLI job's ``io.read_coords`` span, the coordinates' text
read and parsed, mean over the window's jobs."""

from bench_port import spans


def read(ctx):
    return spans.job_mean(ctx.jobs, lambda s, job: spans.wall_s(
        s, "io.read_coords"))
