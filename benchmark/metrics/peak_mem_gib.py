"""peak_mem_gib: torch.cuda.max_memory_allocated over the window, after a
reset at its start."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30
