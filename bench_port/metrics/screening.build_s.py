"""screening.build_s: the series screener's build (a CLI job's
``screener.build`` span, on the write pool while NN runs), mean over
the window's jobs."""

from bench_port import spans


def read(ctx):
    return spans.job_mean(ctx.jobs, lambda s, job: spans.wall_s(
        s, "screener.build"))
