"""The whole step's share of the card's peak: the yardstick's model FLOPs
of a step (``yardstick.step_flops``: the traffic's points, no padding, the
quotient's E(R) head once a row) times the window's steps, over the
window's wall time and the type's published peak (float32 67 TFLOP/s;
float64 67 TFLOP/s on the tensor cores)."""

from .. import yardstick


def read(ctx):
    if not ctx.steps or ctx.window_s <= 0:
        return None
    flops = ctx.step_flops * ctx.steps
    return 100.0 * flops / ctx.window_s / yardstick.PEAK_STEP[ctx.dtype]
