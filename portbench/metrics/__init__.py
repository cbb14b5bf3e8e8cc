"""Per-layer metrics: one reader a metric, ``portbench/metrics/<name>.py``
with ``read(ctx)``, found by the metric's name in ``BENCHMARK.json``.

``ctx`` holds what the traced run measured: ``model`` and ``dtype`` of
the cell, ``points`` a step (the traffic's, padding left out),
``kernel_points`` a step (the points the kernels take, padding in),
``step_flops`` (the yardstick's model FLOPs of a step), ``steps`` and
``window_s`` of the window, ``spans`` (the host's seconds in each
``advance`` of one chunk after the window, each begun with the device's
queue drained), ``launches`` (the program's kernel launches over the
window) and ``profile`` (``trace.parse`` of the traced stretch, with its
``steps``). A reader that finds nothing to read
returns None, and the metric is left out of the result.
"""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def per_step_ms(ctx, group: str):
    """Device ms a step of a group of the trace's kernels ("K1", "K2",
    "K3" or "torch"), or None where the stretch ran none."""
    s = ctx.profile["group_s"].get(group, 0.0)
    if s <= 0.0 or not ctx.profile["steps"]:
        return None
    return 1e3 * s / ctx.profile["steps"]


def roofline(ctx, kernel: str):
    """% of the least time of a step's forward and backward launches of
    ``kernel`` (the yardstick's ``bound_ms`` at the cell's points, width
    and type) in their measured device time a step. The points are those
    the kernel takes, padding in: the bound is of the launch as made."""
    from .. import yardstick
    ms = per_step_ms(ctx, kernel)
    if ms is None:
        return None
    bound = sum(yardstick.bound_ms(ctx.kernel_points, ctx.model["hidden"],
                                   ctx.dtype, which, kernel)[0]
                for which in ("fwd", "bwd"))
    return 100.0 * bound / ms
