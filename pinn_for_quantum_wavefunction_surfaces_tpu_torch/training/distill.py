"""Eigenvalue-head distillation: fit E(R) to the Rayleigh quotient of the
trained wavefunction.

The PyTorch counterpart of the JAX package's ``training/distill.py``. With
psi frozen, the optimal eigenvalue at each R is the Rayleigh quotient
E*(R) = <psi|H|psi>/<psi|psi>; this module computes E*(R) on a grid of R
values by quadrature (``analysis.energy``, through the params' kernel) and
regresses the E head onto it (Adam, then L-BFGS keeping the best iterate).
Only the E head (e1, e2, eout) changes.

The optimisers are torch's (Adam with optax's defaults; L-BFGS with a
strong-Wolfe line search, one iteration a step), not optax's: the two take
different paths, so the port is held to the fit RMS, not to the trajectory.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..analysis import energy as aen
from ..config import Config
from ..models import ansatz

HEAD = ("e1", "e2", "eout")
# where fit_energy_head runs, whatever the params' device (its docstring)
FIT_DEVICE = torch.device("cpu")
# L-BFGS steps between rescalings of the objective, and line-search
# evaluations a step
LBFGS_BLOCK, LBFGS_MAX_LS = 200, 25


def rayleigh_targets(params: dict, cfg: Config, r_values=None,
                     n: Optional[int] = None, scheme: str = "avg",
                     grid: str = "spheroidal") -> tuple[np.ndarray,
                                                        np.ndarray]:
    """E*(R) at each R (port params): spheroidal Gauss quadrature by
    default, or the adapted or uniform Cartesian grids with n nodes an
    axis. Default R values: r_lo to r_hi in steps of 0.05."""
    dom = cfg.domain
    if r_values is None:
        r_values = np.round(np.arange(dom.r_lo, dom.r_hi + 0.05, 0.05), 3)
    r_values = np.asarray(r_values, np.float64)
    targets = np.zeros(len(r_values))
    for i, ri in enumerate(r_values):
        if grid == "spheroidal":
            targets[i] = aen.rayleigh_quotient_spheroidal(params, cfg,
                                                          float(ri))
        elif grid == "adapted":
            n_eff = (n or cfg.train.n_test)
            n_eff = n_eff * 2 if ri < 1.6 else n_eff
            targets[i] = aen.rayleigh_quotient_adapted(params, cfg, float(ri),
                                                       n=n_eff)
        elif grid == "uniform":
            targets[i] = aen.rayleigh_quotient(params, cfg, float(ri), n=n,
                                               scheme=scheme)
        else:
            raise ValueError(f"unknown grid {grid!r}")
    return r_values, targets


def fit_energy_head(params: dict, r_values, targets, lr: float = 3e-3,
                    steps: int = 5000, lbfgs_steps: int = 8000) -> dict:
    """Regress the E head onto (r, E*) pairs by the MSE: ``steps`` Adam
    steps, then ``lbfgs_steps`` full-batch L-BFGS steps, returning the best
    L-BFGS iterate (a late line-search overshoot must not erase the
    descent). Port params; every other subtree is returned untouched (the
    same tensor objects), and the fitted head lands on the device and in
    the dtype of ``params``.

    The fit always runs on the host CPU, whatever the params' device:
    - the head depends on R alone, so it needs nothing of the wavefunction;
    - 77 targets and a 1 153-weight head make every step a few dozen tiny
      operations, each bound by its launch latency on a GPU;
    - torch's strong-Wolfe L-BFGS reads values back to the host at every
      evaluation, so the loop cannot be captured in a CUDA graph.
    It runs on one torch thread: its operations are far too small to
    share between threads, so a thread pool adds only its overhead, and
    the bits are the same either way (tests/test_torch_distill_etab.py
    holds the fit RMS to the bit)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _fit_on_host(params, r_values, targets, lr, steps, lbfgs_steps)
    finally:
        torch.set_num_threads(threads)


def _fit_on_host(params, r_values, targets, lr, steps, lbfgs_steps):
    """fit_energy_head's body, on FIT_DEVICE."""
    host = FIT_DEVICE
    dtype = params["e1"]["w"].dtype
    r = torch.as_tensor(np.asarray(r_values, np.float64), dtype=dtype,
                        device=host)
    t = torch.as_tensor(np.asarray(targets, np.float64), dtype=dtype,
                        device=host)
    head = {k: {f: v.detach().to(host).clone().requires_grad_(True)
                for f, v in params[k].items()} for k in HEAD}
    leaves = [v for k in HEAD for v in head[k].values()]

    def loss():
        return torch.mean((ansatz.energy(head, r) - t) ** 2)

    opt = torch.optim.Adam(leaves, lr=lr)   # optax.adam's defaults
    for _ in range(steps):
        opt.zero_grad()
        loss().backward()
        opt.step()

    def snapshot():
        return [v.detach().clone() for v in leaves]

    best, best_v = snapshot(), math.inf
    done = 0
    while done < lbfgs_steps:
        # torch's L-BFGS keeps a curvature pair only when y.s > 1e-10, and
        # its line search stops at a fixed bracket width; a good fit's MSE
        # is ~1e-11 Ha^2, so each block of steps minimises the MSE scaled
        # to 1 at the block's start, with fresh curvature memory
        with torch.no_grad():
            scale = 1.0 / max(float(loss()), 1e-300)
        # max_eval: up to 25 line-search evaluations a step (max_iter=1
        # alone leaves the line search one, and a rejected step then
        # repeats forever)
        lb = torch.optim.LBFGS(leaves, lr=1.0, max_iter=1,
                               max_eval=1 + LBFGS_MAX_LS, history_size=10,
                               line_search_fn="strong_wolfe",
                               tolerance_grad=0.0, tolerance_change=1e-12)

        def closure():
            lb.zero_grad()
            value = scale * loss()
            value.backward()
            return value

        for _ in range(min(LBFGS_BLOCK, lbfgs_steps - done)):
            cur = snapshot()
            value = lb.step(closure).item() / scale   # the MSE at ``cur``
            if value < best_v:
                best, best_v = cur, value
            done += 1
    if lbfgs_steps:
        with torch.no_grad():
            for v, b in zip(leaves, best):
                v.copy_(b)
    out = dict(params)
    for k in HEAD:
        out[k] = {f: v.detach().to(params[k][f].device)
                  for f, v in head[k].items()}
    return out


def distill(params: dict, cfg: Config, n: Optional[int] = None,
            r_values=None, lr: float = 3e-3,
            steps: int = 5000) -> tuple[dict, dict]:
    """Quadrature targets, then the head regression (port params). Returns
    (new_params, info) with info's targets, fit, fit RMS (Ha) and the wall
    seconds of the two parts."""
    t0 = time.perf_counter()
    r, t = rayleigh_targets(params, cfg, r_values, n=n)
    t1 = time.perf_counter()
    new_params = fit_energy_head(params, r, t, lr=lr, steps=steps)
    ref = new_params["e1"]["w"]
    with torch.no_grad():
        e_fit = ansatz.energy(new_params, torch.as_tensor(
            r, dtype=ref.dtype, device=ref.device)).cpu().numpy()
    info = {"R": r, "targets": t, "fit": e_fit,
            "fit_rms": float(np.sqrt(np.mean((e_fit - t) ** 2))),
            "seconds": {"targets": t1 - t0,
                        "fit": time.perf_counter() - t1}}
    return new_params, info
