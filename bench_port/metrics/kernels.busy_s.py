"""kernels.busy_s: seconds of the union of the traced job's CUDA kernel
intervals inside its window (first to last stage annotation)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["kernels"]:
        return None
    return ctx.trace["kernel_busy_s"]
