"""peak_host_GB: the highest peak RSS of the window's job processes, each
from its own rusage (``os.wait4``), in 1e9 bytes; CLI jobs only."""

from bench_port import stages


def read(ctx):
    peak = stages.job_max(ctx.jobs, "maxrss")
    return None if peak is None else peak / 1e9
