"""io.write_wait_s: the seconds a CLI job's main thread waits on its file
writes (its ``cli.write_wait`` spans, summed), mean over the window's
jobs."""

from bench_port import spans


def read(ctx):
    return spans.job_mean(ctx.jobs, lambda s, job: spans.wall_s(
        s, "cli.write_wait"))
