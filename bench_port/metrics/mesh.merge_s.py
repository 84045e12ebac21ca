"""mesh.merge_s: seconds of a CLI job's ``mesh.merge`` spans, each SUM
or MIN of the devices' partial results (and of their column-block
groups for a bidirectional closure) on the primary device, summed; mean
over the window's jobs. None where a job has no such span."""

from bench_port import spans


def read(ctx):
    return spans.job_mean(ctx.jobs, lambda s, job: spans.wall_s(
        s, "mesh.merge"))
