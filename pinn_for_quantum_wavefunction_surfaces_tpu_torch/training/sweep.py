"""Per-R "multi-model" mode: one independent model per bond length.

The PyTorch counterpart of the JAX package's ``training/sweep.py`` (the
reference's vestigial per-R path, redesigned on the parametric engine with
``domain.fixed_r`` pinned per run):

- ``train_per_r``: the residual trainer once per R, one after another;
- ``polish_per_r``: the deterministic spheroidal polish once per R (a
  single R row), scored by its spheroidal quotient;
- ``train_per_r_vmapped``: the whole family at once. The JAX package
  vmaps one update over a leading model axis; the port steps the models
  one after another inside each step (``torch.func.vmap`` does not pass
  through the kernels' autograd Functions, and on CUDA a symmetric model
  still goes through K2: M forward and M backward launches a step). With
  a mesh the models split over the ranks in contiguous blocks, as JAX's
  ``P("data")`` on the model axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..analysis import energy as aen
from ..config import Config
from ..device import resolve_device, resolve_dtype
from ..models import ansatz
from ..ops.sampling import sample_batch_at_r
from . import engine


def _fixed_r_cfg(cfg: Config, ri: float) -> Config:
    return dataclasses.replace(
        cfg, domain=dataclasses.replace(cfg.domain, fixed_r=float(ri)))


def train_per_r(cfg: Config, r_values: Sequence[float], log_cb=None,
                device="cuda") -> dict:
    """Sequential per-R training (the reference's semantics). Returns
    {"R", "E_net", "params" (per-R numpy trees), "best_loss"}."""
    e_net, losses, params_list = [], [], []
    for ri in r_values:
        res = engine.train(_fixed_r_cfg(cfg, ri), log_cb=log_cb,
                           device=device)
        params_list.append(res.best_params)
        best = ansatz.as_params(res.best_params,
                                resolve_dtype(cfg.dtype),
                                resolve_device(device))
        e_net.append(aen.energy_net(best, float(ri)))
        losses.append(res.best_loss)
    return {"R": np.asarray(r_values), "E_net": np.asarray(e_net),
            "params": params_list, "best_loss": np.asarray(losses)}


def polish_per_r(cfg: Config, r_values: Sequence[float],
                 params: Optional[dict] = None, steps: int = 300,
                 n_xi: int = 40, n_eta: int = 24, log_cb=None,
                 device="cuda") -> dict:
    """Per-R family by the deterministic spheroidal polish: each bond
    length gets its own copy of the (seeded or given) params, L-BFGS on
    its exact single-R Rayleigh quotient (``head_weight`` 0), scored by
    the 96 x 96 spheroidal quotient. "E_net" and "best_loss" are those
    quotients; "params" the per-R port params."""
    from . import variational

    e_int, params_list = [], []
    for ri in r_values:
        out = variational.polish_spheroidal(
            params, _fixed_r_cfg(cfg, ri), n_r=1, n_xi=n_xi, n_eta=n_eta,
            steps=steps, head_weight=0.0, log_cb=log_cb, device=device)
        params_list.append(out)
        e_int.append(aen.rayleigh_quotient_spheroidal(out, cfg, float(ri)))
    return {"R": np.asarray(r_values, np.float64),
            "E_net": np.asarray(e_int),
            "params": params_list,
            "best_loss": np.asarray(e_int)}


def model_seeds(seed: int, index: int) -> tuple[int, int]:
    """(init seed, batch seed) of model ``index`` of a sweep: each model
    its own init and its own stream (JAX splits PRNGKey(seed))."""
    a, b = np.random.SeedSequence([int(seed), int(index)]).generate_state(2)
    return int(a), int(b)


def train_per_r_vmapped(cfg: Config, r_values: Sequence[float], mesh=None,
                        init: Optional[list] = None,
                        device="cuda") -> dict:
    """Train the per-R family together: model i has its own init, its own
    batch at its own R (``sample_batch_at_r``), its own Adam state and its
    own best tracking; every step advances every model once. Returns
    {"R", "E_net" (the E head of each best), "params" (the best params,
    numpy, stacked on a leading model axis), "best_loss",
    "loss_history" (epochs, M)}.

    ``init``: per-model (params, batch) to start from (numpy trees and
    ``Batch`` tensors), instead of the seeded ones (``model_seeds``).
    ``mesh``: the models split over the ranks in contiguous blocks; M must
    be a multiple of the mesh size, as the JAX package's sharding requires.
    Every rank returns the whole family."""
    r_values = np.asarray(r_values, dtype=np.float64)
    m = len(r_values)
    t = cfg.train
    dev = mesh.device if mesh is not None else resolve_device(device)
    dtype = resolve_dtype(cfg.dtype)
    mine = range(m) if mesh is None else range(m)[mesh.block(m, "models")]
    trainers, samplers = [], []
    for i in mine:
        ri = float(r_values[i])
        p_seed, b_seed = model_seeds(t.seed, i)
        gen = torch.Generator(device=dev).manual_seed(b_seed)
        if init is None:
            params = ansatz.init_params(cfg.model, seed=p_seed, dtype=dtype,
                                        device=dev)
            batch = sample_batch_at_r(gen, cfg, ri, n=t.n_train, device=dev)
        else:
            params, batch = init[i]
            batch = type(batch)(*(a.to(dev) for a in batch))
        trainers.append(engine.Trainer(cfg, params, batch=batch,
                                       generator=gen, device=dev))
        samplers.append(lambda g, ri=ri: sample_batch_at_r(
            g, cfg, ri, n=t.n_train, device=dev))
    # the loss history in the loss type (float32 for bfloat16 models)
    losses = torch.empty((t.epochs, len(trainers)),
                         dtype=torch.promote_types(dtype, torch.float32),
                         device=dev)
    for e in range(t.epochs):
        for j, (tr, sample) in enumerate(zip(trainers, samplers)):
            losses[e, j] = tr.advance(sample).l_tot
    local = {
        "E_net": [aen.energy_net(tr.state().best_params,
                                 float(r_values[i]))
                  for i, tr in zip(mine, trainers)],
        "params": [ansatz.to_numpy_params(tr.state().best_params)
                   for tr in trainers],
        "best_loss": [float(tr.best_loss) for tr in trainers],
        "loss_history": losses.cpu().numpy(),
    }
    parts = [local] if mesh is None else mesh.gather(local)
    best = [p for part in parts for p in part["params"]]
    return {"R": r_values,
            "E_net": np.asarray([e for part in parts for e in part["E_net"]]),
            "params": {k: {f: np.stack([b[k][f] for b in best])
                           for f in best[0][k]} for k in best[0]},
            "best_loss": np.asarray([v for part in parts
                                     for v in part["best_loss"]]),
            "loss_history": np.concatenate([part["loss_history"]
                                            for part in parts], axis=1)}
