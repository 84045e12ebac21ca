"""peak_device_GB: the highest ``torch.cuda.max_memory_allocated`` of any
job of the window, over its cards, in 1e9 bytes."""


def read(ctx):
    return max(job["peak_allocated"] for job in ctx.jobs) / 1e9
