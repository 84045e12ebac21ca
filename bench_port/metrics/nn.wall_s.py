"""nn.wall_s: the nearest-neighbour stage, mean over the window's jobs
(CLI: ``[nearest neighbors: ...]``; API: the span around
``nearest_neighbors``)."""

from bench_port import stages


def read(ctx):
    return stages.job_mean(ctx.jobs, "nearest_neighbors")
