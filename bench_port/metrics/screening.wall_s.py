"""screening.wall_s: the screening stage, mean over the window's jobs
(CLI: ``[screening setup: ...]`` and every ``[screening <t>: ...]``; API:
the span around ``screening_series``)."""

from bench_port import stages


def read(ctx):
    return stages.job_mean(ctx.jobs, "screening")
