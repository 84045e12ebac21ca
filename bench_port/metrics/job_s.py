"""job_s: seconds per density job, the window's job walls over the jobs
completed in it (CLI: spawn to exit; API: first call to synchronize)."""


def read(ctx):
    return sum(job["wall"] for job in ctx.jobs) / len(ctx.jobs)
