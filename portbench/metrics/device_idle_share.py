"""% of the traced stretch's wall time in which no kernel, copy or set ran
on the device."""


def read(ctx):
    w = ctx.profile["window_s"]
    if w <= 0:
        return None
    return 100.0 * (1.0 - ctx.profile["busy_s"] / w)
