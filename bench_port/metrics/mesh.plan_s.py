"""mesh.plan_s: seconds of a CLI job's ``mesh.plan`` spans, each stage's
planning of the row blocks dealt to each device of the mesh (the block
bounds, planes, closures and tile lists of its own rows), summed; mean
over the window's jobs. None where a job has no such span (one device,
or a program that plans every list on its primary device)."""

from bench_port import spans


def read(ctx):
    return spans.job_mean(ctx.jobs, lambda s, job: spans.wall_s(
        s, "mesh.plan"))
