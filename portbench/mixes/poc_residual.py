"""The paper's own network (poc/main.py) under the residual trainer: the
first stage of ``make ref-recipe``.

The program's entry and loop are ``residual``'s (``engine.Trainer``, its
step and its draw captured on the card). The harness draws the symmetric
family's layout, alpha(R) and b(R) heads included (``weights.make``); the
program keys those heads by the tree (``"alpha1" in params``), so
``strip`` drops their four layers before either side sees the weights: psi
= g(R) Lin_out(B) + e^{-r1} + e^{-r2}, which the card carries through K2
and the R-heads pair with alpha and b widths 0. The reference is
``reference/poc.py``, on batches derived again from the seed as
``residual.reference`` derives them.

Traffic keys: as ``residual``'s.
"""

from __future__ import annotations

import torch

from ..reference import follow, poc, sampling
from . import record_steps
from .monte_carlo import lr_of
from .residual import ResidualMix

OBJECTIVE = "residual"
HEADS = ("alpha1", "alpha2", "beta1", "beta2")


def strip(params: dict) -> dict:
    """``params`` without the alpha(R) and b(R) layers (the leaves it keeps
    are shared, not copied)."""
    return {k: v for k, v in params.items() if k not in HEADS}


class PocResidualMix(ResidualMix):
    """``ResidualMix``'s steps and reads on the stripped tree."""

    def record(self, params, steps):
        """The record of the stripped tree's leaves (``params`` is the
        layout the harness drew)."""
        return record_steps(self, strip(params), steps)


def build(cfg, traffic, params, seed, device):
    return PocResidualMix(cfg, traffic, strip(params), seed, device)


def reference(cfg, traffic, params, seed, device, dtype, steps=3, keep=1.0,
              use_tf32=False):
    t = traffic["train"]
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def draw():
        b = sampling.collocation(gen, cfg["domain"], t["n_train"],
                                 getattr(torch, traffic["dtype"]))
        return tuple(x.to(dtype) if x.is_floating_point() else x for x in b)

    # the first batch before the first step, then the schedule's draws
    batches, cur = [], draw()
    for i in range(steps):
        if i % t["resample_every"] == 0 and \
                i < int(t["resample_frac"] * t["epochs"]):
            cur = draw()
        batches.append(cur)
    return follow(strip(params), dtype, steps, lambda i: batches[i],
                  lambda p, b: poc.residual(p, b, keep=keep), lr_of(traffic),
                  use_tf32=use_tf32)
