"""The flagship polish's L-BFGS on its fixed quadrature batch.

The program's optimiser is ``lbfgs.LBFGS`` (optax's curvature memory on a
strong-Wolfe line search), which ``variational._lbfgs_minimize`` steps on
the quotient objective of the dual-grid batch, selecting the best iterate
on a third, validation grid: a step evaluates the validation objective
once and the training objective and its gradient one or more times. The
program has no step object for it, so this kind takes that loop's body
one step at a time; it runs eagerly, the host waiting on each line-search
evaluation. ``evaluations`` counts the objective's evaluations.

The comparison reads the first evaluation only (the loss and gradient at
the initial weights): the reference has no line search to follow.

Traffic keys: dtype, n_r, n_xi, n_eta, memory, max_ls, head_weight,
read_every.
"""

from __future__ import annotations

import torch

from .. import program
from ..reference import leaf_names, objectives, sampling
from . import Mix, leaf_norms

OBJECTIVE = "quotient"


class LbfgsMix(Mix):
    def __init__(self, cfg, traffic, params, seed, device):
        v = program.module("training.variational")
        lbfgs = program.module("training.lbfgs")
        c = program.config(cfg, traffic)
        n = (traffic["n_r"], traffic["n_xi"], traffic["n_eta"])
        self.vb = v.dual_grid_vbatch(c, *n, dtype=c.dtype, device=device)
        self.vbv = v.validation_vbatch(c, *n, dtype=c.dtype, device=device)
        self.points = sampling.dual_grid_points(*n)
        self.kernel_points = self.vb.x.numel()
        self.rows = self.vb.x.shape[0]
        self.steps = 0
        self.read_every = traffic["read_every"]
        self.c, self.v, self.hw = c, v, traffic["head_weight"]
        self.p = {k: {f: t.detach().clone().requires_grad_(True)
                      for f, t in d.items()} for k, d in params.items()}
        self.leaves = [self.p[n.split("/")[0]][n.split("/")[1]]
                       for n in leaf_names(self.p)]
        self.opt = lbfgs.LBFGS(self.leaves, memory_size=traffic["memory"],
                               max_ls=traffic["max_ls"])
        self.evaluations = 0
        self.first = None          # (loss, flat gradient) of the first call
        self.value = None

    def _closure(self):
        self.opt.zero_grad()
        loss = self.v.quotient_loss(self.p, self.c, self.vb, self.hw)[0]
        loss.backward()
        self.evaluations += 1
        if self.first is None:
            self.first = (float(loss.detach()), torch.cat(
                [t.grad.detach().reshape(-1) for t in self.leaves]))
        return loss

    def step(self):
        with torch.no_grad():
            self.val = self.v.quotient_loss(self.p, self.c, self.vbv,
                                            self.hw)[0]
        self.value = self.opt.step(self._closure)
        self.steps += 1

    def read(self):
        return float(self.val)

    def loss(self):
        return float(self.value)

    def notes(self):
        return {"evaluations_per_step": self.evaluations / max(self.steps, 1),
                "validation_points": self.vbv.x.numel()}

    def record(self, params, steps):
        for _ in range(steps):
            self.step()
        return {"loss": [self.first[0]],
                "grad": leaf_norms(self.first[1], params), "change": {}}


def build(cfg, traffic, params, seed, device):
    return LbfgsMix(cfg, traffic, params, seed, device)


def reference(cfg, traffic, params, seed, device, dtype, steps=3, keep=1.0,
              use_tf32=False):
    from ..reference import tf32
    batch = sampling.dual_grid(cfg["domain"], traffic["n_r"],
                               traffic["n_xi"], traffic["n_eta"],
                               getattr(torch, traffic["dtype"]), device)
    batch = tuple(t.to(dtype) for t in batch)
    p = {k: {f: t.detach().to(dtype).clone().requires_grad_(True)
             for f, t in d.items()} for k, d in params.items()}
    with tf32(use_tf32):
        loss, grads = objectives.quotient(cfg["model"]["arch"], p, batch,
                                          traffic["head_weight"], keep=keep)
    return {"loss": [loss], "change": {},
            "grad": {n: float(g.double().norm())
                     for n, g in zip(leaf_names(p), grads)}}
