"""device.idle_share: the share of the traced job's window (first to last
stage annotation) in which the card ran no kernel, copy or set."""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"]
