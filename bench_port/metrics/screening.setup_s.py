"""screening.setup_s: the wait for the screener's build
(``[screening setup: ...]`` of a CLI job), mean over the window's
jobs."""

from bench_port import stages


def read(ctx):
    return stages.job_mean(ctx.jobs, "screening_setup")
