"""The Monte-Carlo variational trainer: a fresh importance draw every step.

The program's entry is ``variational.MonteCarloTrainer``: the draw of
n_r half-distances and n_pts importance samples each (``sample_vbatch``),
the quotient objective and its gradient, Adam and the EMA, captured with
the draw as one CUDA graph on the card. The loop is
``train_variational``'s: each step's history row copied into the chunk's
buffer, which the host reads every ``read_every`` steps.

Traffic keys: dtype, n_r, n_pts, antithetic, stratified, ema_decay,
read_every, and ``train`` (the schedule: lr, lr_schedule).
"""

from __future__ import annotations

import torch

from .. import program
from ..reference import follow, objectives, sampling
from . import Mix, f32_staircase

OBJECTIVE = "quotient"


class MonteCarloMix(Mix):
    def __init__(self, cfg, traffic, params, seed, device):
        v = program.module("training.variational")
        self.cfg = c = program.config(cfg, traffic)
        self.points = self.kernel_points = traffic["n_r"] * traffic["n_pts"]
        self.rows = traffic["n_r"]
        self.read_every = traffic["read_every"]
        self.b1 = c.train.betas[0]
        gen = torch.Generator(device=device).manual_seed(int(seed))
        self.mc = v.MonteCarloTrainer(
            c, params, traffic["n_r"], traffic["n_pts"], gen,
            traffic["ema_decay"], traffic["antithetic"],
            traffic["stratified"], device)
        self.hist, self.j = None, 0

    def step(self):
        if self.j == 0:
            self.hist = torch.empty((self.read_every, 3),
                                    dtype=self.mc.row.dtype,
                                    device=self.mc.row.device)
        self.mc.advance()
        self.hist[self.j].copy_(self.mc.row)
        self.j += 1

    def read(self):
        last = self.hist[:self.j].cpu().numpy()[-1]
        self.j = 0
        return float(last[0])

    def loss(self):
        return float(self.mc.row[0])

    def flat(self):
        return self.mc.flat

    def first_moment(self):
        return self.mc.opt.mu


def build(cfg, traffic, params, seed, device):
    return MonteCarloMix(cfg, traffic, params, seed, device)


def lr_of(traffic):
    """The rate of each step under the traffic's schedule."""
    t = traffic["train"]
    if t.get("lr_schedule", "none") == "step":
        return lambda i: f32_staircase(t["lr"], t["sc_decay"], t["sc_step"],
                                       i)
    return lambda i: t["lr"]


def reference(cfg, traffic, params, seed, device, dtype, steps=3, keep=1.0,
              use_tf32=False):
    gen = torch.Generator(device=device).manual_seed(int(seed))
    batches = []

    def batch_of(i):
        while len(batches) <= i:
            b = sampling.importance(gen, cfg["domain"], traffic["n_r"],
                                    traffic["n_pts"],
                                    getattr(torch, traffic["dtype"]),
                                    traffic["antithetic"],
                                    traffic["stratified"])
            batches.append(tuple(t.to(dtype) for t in b))
        return batches[i]

    family = cfg["model"]["arch"]
    return follow(params, dtype, steps, batch_of,
                  lambda p, b: objectives.quotient(family, p, b, keep=keep),
                  lr_of(traffic), use_tf32=use_tf32)
