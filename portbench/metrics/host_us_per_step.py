"""Host microseconds to issue one step: the mean of ``advance`` over one
chunk after the window, each call begun with the device's queue drained,
so that no wait on a full queue is counted; read outside the profiled
stretch."""


def read(ctx):
    if not ctx.spans:
        return None
    return 1e6 * sum(ctx.spans) / len(ctx.spans)
