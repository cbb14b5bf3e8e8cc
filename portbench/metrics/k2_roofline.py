"""K2's share of its roofline: its forward and backward launches' least
time at the cell's points over their device time a step."""

from . import roofline


def read(ctx):
    return roofline(ctx, "K2")
