"""cli.outside_stages_s: a CLI job's wall less the sum of its ``-v`` stage
walls (imports, CUDA start, text read, writes not overlapped, exit), mean
over the window's jobs."""

from bench_port import stages


def read(ctx):
    return stages.job_mean(ctx.jobs, "outside_stages")
