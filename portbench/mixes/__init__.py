"""Traffic kinds: one module a kind, found by the ``kind`` of a traffic
file (``portbench/traffic/<traffic>.json``).

A kind module has

- ``OBJECTIVE``: "quotient" or "residual", which the yardstick's FLOP
  count of a step takes (``yardstick.step_flops``);
- ``build(cfg, traffic, params, seed, device)``: the program's entry
  object for the cell, driven from ``params`` and ``seed``, wrapped in a
  ``Mix``;
- ``reference(cfg, traffic, params, seed, device, dtype, steps, keep,
  use_tf32)``: ``reference.follow``'s record of the same first steps,
  with every batch derived again from the seed.

A ``Mix`` takes one step as the program's own loop takes it (``step``),
reads the device as that loop does every ``read_every`` steps (``read``),
and after a step gives what the comparison reads of the program: the
step's loss, the trained vector and Adam's first moment.
"""

from __future__ import annotations

import importlib

import torch

from ..reference import leaf_names


def load(kind: str):
    return importlib.import_module(f"{__name__}.{kind}")


class Mix:
    points = 0          # the traffic's points a step, padding left out
    kernel_points = 0   # the points the kernels take a step, padding in
    rows = 0            # R rows a step (the quotient's)
    read_every = 1      # steps between the host's reads of the device
    b1 = 0.9            # Adam's first decay

    def step(self) -> None:
        raise NotImplementedError

    def read(self) -> float:
        """The host's read at the end of a chunk: the last step's loss."""
        raise NotImplementedError

    def loss(self) -> float:
        """The loss of the step just taken (the params before it)."""
        raise NotImplementedError

    def flat(self) -> torch.Tensor:
        """The trained vector: every leaf in sorted order, flattened."""
        raise NotImplementedError

    def first_moment(self) -> torch.Tensor:
        raise NotImplementedError

    def record(self, params: dict, steps: int) -> dict:
        """The program's record of its first ``steps`` steps."""
        return record_steps(self, params, steps)

    def notes(self) -> dict:
        """Counts of the run worth keeping beside the result."""
        return {}


def leaf_norms(vec: torch.Tensor, params: dict) -> dict:
    """{leaf: norm} of a flat vector laid out as ``params``' leaves."""
    out, at = {}, 0
    for name in leaf_names(params):
        k, f = name.split("/")
        n = params[k][f].numel()
        out[name] = float(vec[at:at + n].double().norm())
        at += n
    if at != vec.numel():
        raise ValueError(f"the trained vector has {vec.numel()} values, the "
                         f"weights {at}")
    return out


def record_steps(mix: Mix, params: dict, steps: int) -> dict:
    """The program's record of its first ``steps`` steps, taken through
    ``mix.step``: each loss, the first gradient's leaves (Adam's first
    moment after one step over 1 - b1) and each leaf's change."""
    start = mix.flat().detach().clone()
    rec = {"loss": []}
    for i in range(steps):
        mix.step()
        rec["loss"].append(mix.loss())
        if i == 0:
            rec["grad"] = leaf_norms(mix.first_moment().double()
                                     / (1.0 - mix.b1), params)
    rec["change"] = leaf_norms(mix.flat().detach().double() - start.double(),
                               params)
    return rec


def f32_staircase(lr: float, decay: float, every: int, count: int) -> float:
    """optax's staircase exponential_decay in float32 on an int32 count,
    lr decay^floor(count / every): the recipes' schedules."""
    import numpy as np
    f32 = np.float32
    return float(f32(lr) * f32(decay) ** f32(count // every))
