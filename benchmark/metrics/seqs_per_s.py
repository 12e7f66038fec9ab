"""seqs_per_s: sequences whose outputs reached the host in the window,
over the window's whole time (host clock)."""


def read(ctx):
    return ctx.seqs / ctx.window_s
