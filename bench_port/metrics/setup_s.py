"""setup_s: seconds from the harness's start to the first job: the
frames, their text, the build or load of what the jobs need."""


def read(ctx):
    return ctx.setup_s
