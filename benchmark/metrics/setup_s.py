"""setup_s: from the start of the process to the first timed call: the
imports, the build or load of the kernels, the tables, the traffic and the
warm-up calls."""


def read(ctx):
    return ctx.setup_s
