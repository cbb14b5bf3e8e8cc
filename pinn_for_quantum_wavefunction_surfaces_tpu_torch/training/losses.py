"""Loss functions of the residual trainer: PDE residual + boundary decay.

The PyTorch counterpart of the JAX package's ``training/losses.py``:

    L_pde = mean(residual^2)            over the whole collocation batch
    L_bc  = mean(psi^2 | r1 >= BCcutoff) + mean(psi^2 | r2 >= BCcutoff)
    L_tot = lam_pde * L_pde + lam_bc * L_bc

with the options ``residual_weight="lcao"``, ``scale_invariant`` and
``correction_reg``. Every mean is a (sum, count) pair with ``allreduce``
applied to each, so a data-parallel caller can put an all-reduce there and
get the global loss. psi, lap psi and E come from the fused kernel of the
symmetric family (``ops.pallas_train.psi_lap_train``): on the card every
loss launches its forward kernel and every gradient its backward kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Config
from ..models import ansatz
from ..ops import operators
from ..ops.pallas_train import psi_lap_train
from ..ops.sampling import Batch


class LossAux(NamedTuple):
    l_pde: torch.Tensor
    l_bc: torch.Tensor
    e_last: torch.Tensor   # E of the last batch point
    e_mean: torch.Tensor


def loss_fn(params: dict, cfg: Config, batch: Batch, lam_pde: float = 1.0,
            lam_bc: float = 1.0, allreduce=None):
    """(total loss, LossAux) for one collocation batch. ``allreduce`` is
    applied to every batch sum and count (identity by default)."""
    ar = (lambda v: v) if allreduce is None else allreduce
    psi_v, lap_v, e = psi_lap_train(params, cfg.model, batch.x, batch.y,
                                    batch.z, batch.r)
    res = operators.RESIDUALS[cfg.convention](
        cfg.model, batch.x, batch.y, batch.z, batch.r, psi_v, lap_v, e)
    # global point count, a tensor so that it can be all-reduced
    n = ar(torch.full((), res.shape[0], dtype=res.dtype, device=res.device))
    if cfg.train.residual_weight == "lcao":
        # local-energy-variance weighting: |(H-E)psi|^2 weighted by the
        # LCAO density, floored so the far field keeps anchoring E
        w = ansatz.lcao(cfg.model, batch.x, batch.y, batch.z, batch.r) ** 2
        w = w / (ar(torch.sum(w)) / n + 1e-30)
        floor = cfg.train.residual_weight_floor
        weight = (w + floor) / (1.0 + floor)
        l_pde = ar(torch.sum(res ** 2 * weight)) / n
    else:
        l_pde = ar(torch.sum(res ** 2)) / n
    psi2 = psi_v ** 2

    def bc_mean(mask):
        count = torch.clamp(ar(torch.sum(mask)), min=1)
        return ar(torch.sum(torch.where(mask, psi2, 0.0))) / count

    l_bc = bc_mean(batch.bc1) + bc_mean(batch.bc2)
    if cfg.train.scale_invariant:
        # invariant under psi -> c psi (differentiable through the norm)
        norm = ar(torch.sum(psi2)) / n + 1e-30
        l_pde = l_pde / norm
        l_bc = l_bc / norm
    l_tot = lam_pde * l_pde + lam_bc * l_bc
    if cfg.train.correction_reg > 0.0:
        lc = ansatz.lcao(cfg.model, batch.x, batch.y, batch.z, batch.r,
                         params)
        corr = psi_v - lc
        l_tot = l_tot + cfg.train.correction_reg * (
            (ar(torch.sum(corr ** 2)) / n)
            / (ar(torch.sum(lc ** 2)) / n + 1e-30))
    return l_tot, LossAux(l_pde, l_bc, e[-1], ar(torch.sum(e)) / n)


def loss_and_grad(params: dict, cfg: Config, batch: Batch):
    """(loss, aux, grads): grads a tree like ``params`` (zeros where the
    loss does not depend on a leaf, as jax.grad gives)."""
    keys = [(k, f) for k in sorted(params) for f in sorted(params[k])]
    p = {k: {f: t.detach().requires_grad_(True) for f, t in v.items()}
         for k, v in params.items()}
    l, aux = loss_fn(p, cfg, batch)
    leaves = [p[k][f] for k, f in keys]
    gs = torch.autograd.grad(l, leaves, allow_unused=True)
    grads: dict = {}
    for (k, f), g, t in zip(keys, gs, leaves):
        grads.setdefault(k, {})[f] = torch.zeros_like(t) if g is None else g
    return l.detach(), LossAux(*(a.detach() for a in aux)), grads
