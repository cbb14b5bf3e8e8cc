"""An excited state's polish: the Adam warmup on the penalty-deflated
quotient, on its fixed quadrature batch.

The program's entry is ``variational.AdamWarmup`` on the objective that
``polish_spheroidal`` builds (``variational.polish_objective``): the
references' rows computed once on the dual-grid batch
(``dual_grid_vbatch``), then each step one evaluation of the deflated
quotient (``quotient_loss_deflated``) and its gradient and one Adam
update, captured as a CUDA graph on the card. No kernel of the program
carries the excited family: psi and lap psi come from the forward-Laplacian
pass at every point. The rate is the recipe's staircase (``warmup_steps``
steps, halving every quarter; past them it goes on halving, which changes
no work), and the loop reads the loss every ``read_every`` steps.

The configuration names the references (``deflate``: checkpoints under
``portbench/``, read with numpy) and the excited model. The harness draws
the ground layout of the family (``weights.make``); ``complete`` turns it
into the excited layout, the same on both sides.

Traffic keys: dtype, n_r, n_xi, n_eta, lr, warmup_steps, head_weight,
read_every.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from .. import program, weights
from ..reference import excited, follow, sampling
from . import f32_staircase, record_steps
from .adam_warmup import AdamWarmupMix

OBJECTIVE = "quotient"
HERE = Path(__file__).resolve().parents[1]
XALPHA_BIAS = math.atanh((1.0 - 1.275) / 0.975)   # alpha(R) = 1 at init
ENODE_BIAS = math.log(0.5)                         # eta0^2(R) = 1/3 at init
# the fixed draw of the angular node's first layer (as BASE_SEED is the
# rest's); the run's seed permutes its units
ENODE_SEED = weights.BASE_SEED + 1


def complete(params: dict, model: dict, seed: int) -> dict:
    """The excited layout of ``model`` from the separable ground layout
    that ``weights.make`` draws (the leaves it keeps are shared, not
    copied): with ``wide_alpha`` the alpha head's first layer becomes
    "xalpha1" as drawn and "xalpha2" a zero weight with the bias of alpha =
    1; with ``eta_node``, "enode1" is drawn U(+/-1) from ``ENODE_SEED`` on
    the device, its units permuted by a generator seeded with ``seed`` (as
    ``weights.make`` permutes each layer's), and "enode2" is a zero weight
    with the bias of eta0^2 = 1/3. ``m_abs`` adds no leaf."""
    out = dict(params)
    like = params["e1"]["w"]
    dev, dtype = like.device, like.dtype
    ha = model["hidden_alpha"]

    def zero_out(bias):
        return {"w": torch.zeros((ha, 1), dtype=dtype, device=dev),
                "b": torch.full((1,), bias, dtype=dtype, device=dev)}

    if model.get("wide_alpha"):
        out["xalpha1"] = out.pop("alpha1")
        del out["alpha2"]
        out["xalpha2"] = zero_out(XALPHA_BIAS)
    if model.get("eta_node"):
        gen = torch.Generator(device=dev).manual_seed(ENODE_SEED)
        u = 2.0 * torch.rand(2 * ha, generator=gen, dtype=torch.float64,
                             device=dev) - 1.0
        perm = torch.randperm(
            ha, generator=torch.Generator(device=dev).manual_seed(int(seed)),
            device=dev)
        out["enode1"] = {"w": u[:ha].view(1, ha)[:, perm].to(dtype),
                         "b": u[ha:][perm].to(dtype)}
        out["enode2"] = zero_out(ENODE_BIAS)
    return out


def references(cfg: dict) -> list[dict]:
    """The configuration's reference states as {name: {"w", "b"}} of numpy
    arrays, in its order."""
    out = []
    for rel in cfg["deflate"]:
        with np.load(HERE / rel) as f:
            tree = {}
            for key in f.files:
                head, _, leaf = key.partition("/")
                if head == "params":
                    name, field = leaf.split("/")
                    tree.setdefault(name, {})[field] = f[key]
        out.append(tree)
    return out


class DeflatedWarmupMix(AdamWarmupMix):
    """``AdamWarmupMix``'s steps and reads on the deflated objective."""

    def __init__(self, cfg, traffic, params, seed, device):
        v = program.module("training.variational")
        c = program.config(cfg, traffic)
        vb = v.dual_grid_vbatch(c, traffic["n_r"], traffic["n_xi"],
                                traffic["n_eta"], dtype=c.dtype,
                                device=device)
        # the grids' own points are the work; the forward-Laplacian pass
        # also takes the first grid's padding up to the second's size
        self.points = sampling.dual_grid_points(
            traffic["n_r"], traffic["n_xi"], traffic["n_eta"])
        self.kernel_points = vb.x.numel()
        self.rows = vb.x.shape[0]
        self.read_every = traffic["read_every"]
        self.start = complete(params, cfg["model"], seed)
        loss_fn = v.polish_objective(c, vb, references(cfg))
        self.warm = v.AdamWarmup(self.start, c, vb, traffic["warmup_steps"],
                                 traffic["head_weight"], lr=traffic["lr"],
                                 loss_fn=loss_fn)

    def record(self, params, steps):
        """The record of the excited layout's leaves (``params`` is the
        ground layout the harness drew)."""
        return record_steps(self, self.start, steps)


def build(cfg, traffic, params, seed, device):
    return DeflatedWarmupMix(cfg, traffic, params, seed, device)


def reference(cfg, traffic, params, seed, device, dtype, steps=3, keep=1.0,
              use_tf32=False):
    batch = sampling.dual_grid(cfg["domain"], traffic["n_r"],
                               traffic["n_xi"], traffic["n_eta"],
                               getattr(torch, traffic["dtype"]), device)
    batch = tuple(t.to(dtype) for t in batch)
    refs = [{k: {f: torch.as_tensor(a, dtype=dtype, device=device)
                 for f, a in v.items()} for k, v in tree.items()}
            for tree in references(cfg)]
    m = cfg["model"].get("m_abs", 0)
    quarter = max(traffic["warmup_steps"] // 4, 1)
    return follow(
        complete(params, cfg["model"], seed), dtype, steps, lambda i: batch,
        lambda p, b: excited.quotient_deflated(
            p, b, refs, m, traffic["head_weight"], keep=keep),
        lambda i: f32_staircase(traffic["lr"], 0.5, quarter, i),
        use_tf32=use_tf32)
