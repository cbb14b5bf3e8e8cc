"""The comparison that decides ``correct``: the program's first steps
against the reference's, by three numbers.

- ``loss``: the largest relative gap |L - L_ref| / |L_ref| of the steps'
  losses;
- ``grad``: the first gradient as Adam got it, by the worst leaf: the gap
  between the program's norm of the leaf and the reference's, against the
  larger of that leaf's reference norm and the median leaf's. The median
  is over the leaves whose first gradient is not exactly zero: at the
  families' init the zero output layers leave 14 of 26 leaves with none,
  and their median, 0, would be no floor;
- ``change``: each leaf's change over the steps, taken the same way, over
  the leaves whose moves the reference's gradient decides: a leaf whose
  gradient at some step is not zero but under a thousandth of the median
  leaf's (over the leaves with a gradient at that step) is nought to
  rounding there, such as the scale direction of a zero-initialised
  output layer at the first step, and Adam, which divides a gradient by
  its own size, moves it by round-off alone: it is left out. A gradient
  that is exactly zero moves nothing on either side and keeps the leaf.

A limit of each number lies between the program's readings over a dozen
seeds and the smallest reading of a lower precision or of a planted fault
(``portbench/limits/<cell>.json`` keeps the readings). A number that is
not finite fails.
"""

from __future__ import annotations

import math
import statistics

# the reference's lower precision that a cell's type is held against:
# (type, TF32 matrix products)
CONTROL = {"float64": ("float32", False), "float32": ("float32", True)}
NEGLIGIBLE = 1e-3


def _worst_leaf(prog: dict, ref: dict, names) -> float:
    """The largest gap of a leaf's norm against the larger of its reference
    norm and the median over ``names`` of the nonzero reference norms."""
    names = list(names)
    nonzero = [ref[n] for n in names if ref[n] > 0.0]
    med = statistics.median(nonzero) if nonzero else 0.0
    return max((abs(prog[n] - ref[n]) / max(ref[n], med, 1e-300)
                for n in names), default=0.0)


def gaps(prog: dict, ref: dict) -> dict:
    """{number: reading} of the program's record against the
    reference's."""
    out = {"loss": max(abs(p - r) / max(abs(r), 1e-300)
                       for p, r in zip(prog["loss"], ref["loss"]))}
    out["grad"] = _worst_leaf(prog["grad"], ref["grad"], ref["grad"])
    if ref["change"]:
        out["change"] = _worst_leaf(prog["change"], ref["change"],
                                    decided(ref["grad_steps"]))
    return out


def decided(grad_steps: dict) -> list[str]:
    """The leaves whose every step's reference gradient is exactly zero or
    at least ``NEGLIGIBLE`` of the median nonzero leaf's at that step."""
    names = list(grad_steps)
    keep = set(names)
    for i in range(len(next(iter(grad_steps.values())))):
        norms = {n: grad_steps[n][i] for n in names}
        nonzero = [v for v in norms.values() if v > 0.0]
        if not nonzero:
            continue
        med = statistics.median(nonzero)
        keep -= {n for n, v in norms.items() if 0.0 < v < NEGLIGIBLE * med}
    return [n for n in names if n in keep]


def decide(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): every number of ``limits``
    read and finite and at most its limit."""
    checks, ok = {}, True
    for name, lim in limits.items():
        v = readings.get(name, math.nan)
        checks[name] = {"value": v, "limit": lim["limit"]}
        ok = ok and math.isfinite(v) and v <= lim["limit"]
    return ok, checks
