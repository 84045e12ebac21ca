"""populations.wall_s: the populations stage, mean over the window's jobs
(CLI: ``[populations: ...]``; API: the spans around ``populations`` and
``free_energies``)."""

from bench_port import stages


def read(ctx):
    return stages.job_mean(ctx.jobs, "populations")
