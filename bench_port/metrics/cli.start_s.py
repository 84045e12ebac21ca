"""cli.start_s: a CLI job's ``cli.start`` span, from the process's
creation to the read of the coordinates (the interpreter, the imports,
the device and the parse), mean over the window's jobs."""

from bench_port import spans


def read(ctx):
    return spans.job_mean(ctx.jobs, lambda s, job: spans.wall_s(
        s, "cli.start"))
