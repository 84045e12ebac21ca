"""populations.best_sort_s: the populations stage's choice of layout
(sub-stage ``t_best_sort`` of a CLI job), mean over the window's jobs."""

from bench_port import stages


def read(ctx):
    return stages.job_mean(ctx.jobs, "best_sort")
