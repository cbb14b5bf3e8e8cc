"""The residual PINN trainer, ``make train``'s recipe.

The program's entry is ``engine.Trainer``: Adam on the residual and
boundary loss over a collocation batch, the batch drawn again every
``resample_every`` steps while the schedule resamples (a captured draw of
its own), best, history row and EMA on static buffers, the step captured
as a CUDA graph on the card. The loop is ``engine.train``'s: the first
batch drawn before the first step, each step's row copied into the
chunk's buffer, and every ``read_every`` steps the host reads the chunk
and the best loss.

Traffic keys: dtype, read_every, and ``train`` (n_train, epochs, lr,
lr_schedule, sc_step, sc_decay, resample_every, resample_frac).
"""

from __future__ import annotations

import torch

from .. import program
from ..reference import follow, objectives, sampling
from . import Mix
from .monte_carlo import lr_of

OBJECTIVE = "residual"


class ResidualMix(Mix):
    def __init__(self, cfg, traffic, params, seed, device):
        engine = program.module("training.engine")
        sampling_ = program.module("ops.sampling")
        c = program.config(cfg, traffic)
        self.points = self.kernel_points = c.train.n_train
        self.read_every = traffic["read_every"]
        self.b1 = c.train.betas[0]
        gen = torch.Generator(device=device).manual_seed(int(seed))
        self.tr = engine.Trainer(c, params, generator=gen, device=device)

        def sample(g):
            return sampling_.sample_batch(g, c, device=device)

        self.sample = sample
        self.tr.batch = sample(gen)
        self.hist, self.j = None, 0

    def step(self):
        if self.j == 0:
            self.hist = torch.empty((self.read_every, 4),
                                    dtype=self.tr.loss_dtype,
                                    device=self.tr.row.device)
        self.tr.advance(self.sample)
        self.hist[self.j].copy_(self.tr.row)
        self.j += 1

    def read(self):
        last = self.hist[:self.j].cpu().numpy()[-1]
        float(self.tr.best_loss)
        self.j = 0
        return float(last[0])

    def loss(self):
        return float(self.tr.row[0])

    def flat(self):
        return self.tr.flat

    def first_moment(self):
        return self.tr.opt.mu


def build(cfg, traffic, params, seed, device):
    return ResidualMix(cfg, traffic, params, seed, device)


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
    family = cfg["model"]["arch"]
    return follow(params, dtype, steps, lambda i: batches[i],
                  lambda p, b: objectives.residual(family, p, b, keep=keep),
                  lr_of(traffic), use_tf32=use_tf32)
