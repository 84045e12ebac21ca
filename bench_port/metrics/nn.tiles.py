"""nn.tiles: the tiles that the nearest-neighbour stage computed, band
pass and phase 2 together (the engine's ``[nn: N tiles computed ...]``
line of a CLI job), mean over the window's jobs; a count that repeats for
a seed."""

from bench_port import stages


def read(ctx):
    return stages.job_mean(ctx.jobs, "nn_tiles")
