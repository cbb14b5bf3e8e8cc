"""The flagship polish's Adam warmup on its fixed quadrature batch.

The program's entry is ``variational.AdamWarmup``: one evaluation of the
quotient objective and its gradient on the dual-grid batch that
``polish_spheroidal`` builds (``dual_grid_vbatch``), and one Adam update,
captured as a CUDA graph on the card. The rate is the recipe's staircase
(``warmup_steps`` steps, halving every quarter); past them the staircase
goes on halving, which changes no work. The program's loop reads the
loss every ``read_every`` steps (``_adam_minimize``: 100).

Traffic keys: dtype, n_r, n_xi, n_eta, lr, warmup_steps, head_weight,
read_every.
"""

from __future__ import annotations

import torch

from .. import program
from ..reference import follow, objectives, sampling
from . import Mix, f32_staircase

OBJECTIVE = "quotient"


class AdamWarmupMix(Mix):
    def __init__(self, cfg, traffic, params, seed, device):
        v = program.module("training.variational")
        c = program.config(cfg, traffic)
        vb = v.dual_grid_vbatch(c, traffic["n_r"], traffic["n_xi"],
                                traffic["n_eta"], dtype=c.dtype,
                                device=device)
        # the grids' own points are the work; the kernels also take the
        # first grid's padding up to the second's size
        self.points = sampling.dual_grid_points(
            traffic["n_r"], traffic["n_xi"], traffic["n_eta"])
        self.kernel_points = vb.x.numel()
        self.rows = vb.x.shape[0]
        self.read_every = traffic["read_every"]
        self.warm = v.AdamWarmup(params, c, vb, traffic["warmup_steps"],
                                 traffic["head_weight"], lr=traffic["lr"])

    def step(self):
        self.warm.advance()

    def read(self):
        return self.warm.loss.item()

    def loss(self):
        return self.warm.loss.item()

    def flat(self):
        return self.warm.flat

    def first_moment(self):
        return self.warm.opt.mu


def build(cfg, traffic, params, seed, device):
    return AdamWarmupMix(cfg, traffic, params, seed, device)


def reference(cfg, traffic, params, seed, device, dtype, steps=3, keep=1.0,
              use_tf32=False):
    batch = sampling.dual_grid(cfg["domain"], traffic["n_r"],
                               traffic["n_xi"], traffic["n_eta"],
                               getattr(torch, traffic["dtype"]), device)
    batch = tuple(t.to(dtype) for t in batch)
    family = cfg["model"]["arch"]
    quarter = max(traffic["warmup_steps"] // 4, 1)
    return follow(
        params, dtype, steps, lambda i: batch,
        lambda p, b: objectives.quotient(family, p, b,
                                         traffic["head_weight"], keep=keep),
        lambda i: f32_staircase(traffic["lr"], 0.5, quarter, i),
        use_tf32=use_tf32)
