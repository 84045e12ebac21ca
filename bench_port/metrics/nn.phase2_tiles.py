"""nn.phase2_tiles: the tiles of the nearest-neighbour stage's phase 2
alone (counter ``phase2_tiles`` of a CLI job's main-thread spans; the
warms' scratch engines count on threads of their own), mean over the
window's jobs; a count that repeats for a seed."""

from bench_port import spans


def read(ctx):
    return spans.job_mean(ctx.jobs, lambda s, job: spans.counter(
        s, "phase2_tiles"))
