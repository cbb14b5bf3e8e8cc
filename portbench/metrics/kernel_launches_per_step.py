"""Launches of the program's kernels a step over the window, by the kernel
wrappers' own counters (a replayed graph adds what its capture
launched)."""


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.launches / ctx.steps
