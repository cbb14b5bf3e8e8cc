"""Deterministic variational training: minimise <psi|H|psi>/<psi|psi>.

The PyTorch counterpart of the spheroidal polish of the JAX package's
``training/variational.py``: per-R prolate-spheroidal Gauss grids make the
per-R Rayleigh quotients exact (no Monte-Carlo noise), the loss is their
mean plus an MSE term fitting the E(R) head, and the optimiser is an Adam
warmup followed by L-BFGS with best-iterate selection on a third,
independent grid. psi and lap psi come from the fused separable kernel
(ops/pallas_separable.py): on the card, every loss evaluation launches its
forward kernel and every gradient its backward kernel.

Not in this port yet: the Monte-Carlo trainer (``train_variational``,
``polish_lbfgs``), deflation (``quotient_loss_deflated``) and the mesh-
sharded polish.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..device import resolve_device, resolve_dtype
from ..models import ansatz
from ..ops import operators
from ..ops.pallas_separable import psi_lap_train_separable

# line-search evaluations an L-BFGS step may spend beyond its first: optax's
# zoom line search (the JAX package's optimiser) defaults to 20 steps
LBFGS_MAX_LS = 20


class VBatch(NamedTuple):
    x: torch.Tensor   # (n_r, n_pts)
    y: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor   # quadrature weights
    r: torch.Tensor   # (n_r,)


def quotient_loss(params: dict, cfg: Config, vb: VBatch,
                  head_weight: float = 1.0):
    """(loss, aux): mean Rayleigh quotient over the R rows + head MSE."""
    n_r, n_pts = vb.x.shape
    rr = vb.r[:, None].expand(n_r, n_pts).reshape(-1)
    psi_f, lap_f, _ = psi_lap_train_separable(
        params, cfg.model, vb.x.reshape(-1), vb.y.reshape(-1),
        vb.z.reshape(-1), rr)
    psi = psi_f.reshape(n_r, n_pts)
    lap = lap_f.reshape(n_r, n_pts)
    v = operators.potential(cfg.model, vb.x, vb.y, vb.z, vb.r[:, None])
    hpsi = -0.5 * lap + v * psi
    num = torch.sum(vb.w * psi * hpsi, dim=1)
    den = torch.sum(vb.w * psi * psi, dim=1)
    e_r = num / den
    e_head = ansatz.energy(params, vb.r)
    l_head = torch.mean((e_head - e_r.detach()) ** 2)
    loss = torch.mean(e_r) + head_weight * l_head
    return loss, {"e_mean": torch.mean(e_r), "l_head": l_head, "e_r": e_r}


def spheroidal_vbatch(cfg: Config, n_r: int = 77, n_xi: int = 48,
                      n_eta: int = 48, xi_span: float | None = None,
                      dtype=None, r_values=None, device="cuda") -> VBatch:
    """Deterministic quadrature batch: per-R prolate-spheroidal Gauss grids
    (analysis.energy.spheroidal_grid) stacked over the R rows. With these
    nodes and weights, quotient_loss computes the exact per-R quotients."""
    from ..analysis.energy import spheroidal_grid

    if cfg.model.ry or cfg.model.rz:
        raise NotImplementedError(
            "spheroidal quadrature assumes the nuclei on the x-axis")
    dev = resolve_device(device)
    dtype = resolve_dtype(cfg.dtype if dtype is None else dtype)
    if xi_span is None:
        xi_span = cfg.domain.xi_span
    dom = cfg.domain
    if r_values is None:
        if dom.fixed_r is not None:
            # one row: duplicating the identical grid would only multiply
            # each step's cost
            r_values = np.asarray([dom.fixed_r])
        elif dom.r_cluster == "log":
            # log(R + 0.3)-clustered rows: denser toward the united-atom
            # end, where the surface curvature concentrates the error
            t = np.linspace(np.log(dom.r_lo + 0.3),
                            np.log(dom.r_hi + 0.3), n_r)
            r_values = np.exp(t) - 0.3
            r_values[0], r_values[-1] = dom.r_lo, dom.r_hi
        else:
            r_values = np.linspace(dom.r_lo, dom.r_hi, n_r)
    r_values = np.asarray(r_values, float)
    xs, ys, ws = [], [], []
    for c in r_values:
        x1, rho1, w1 = spheroidal_grid(float(c), n_xi, n_eta, xi_span)
        xs.append(x1)
        ys.append(rho1)
        ws.append(w1)
    kw = dict(dtype=dtype, device=dev)
    x = torch.as_tensor(np.stack(xs), **kw)
    y = torch.as_tensor(np.stack(ys), **kw)
    return VBatch(x, y, torch.zeros_like(x),
                  torch.as_tensor(np.stack(ws), **kw),
                  torch.as_tensor(r_values, **kw))


def _leaves(params: dict) -> list[torch.Tensor]:
    return [params[k][f] for k in sorted(params) for f in sorted(params[k])]


def _trainable(params: dict) -> dict:
    return {k: {f: t.detach().clone().requires_grad_(True)
                for f, t in v.items()} for k, v in params.items()}


def _snapshot(params: dict) -> dict:
    return {k: {f: t.detach().clone() for f, t in v.items()}
            for k, v in params.items()}


def _lbfgs_minimize(params: dict, cfg: Config, vb: VBatch, steps: int,
                    head_weight: float, log_cb=None, memory_size: int = 15,
                    val_fn=None, restart_margin: float = 1e-3,
                    best_save: Optional[str] = None) -> dict:
    """L-BFGS on quotient_loss over a fixed batch.

    Returns the BEST iterate, not the last (late steps can overshoot).
    ``val_fn`` (params -> scalar): the best iterate is selected by this
    independent-grid value instead of the training objective; when it
    drifts ``restart_margin`` (Ha) above the running best, the optimiser
    restarts from the best iterate with fresh curvature memory.
    ``best_save``: checkpoint the running best every 100 steps.

    The optimiser is torch.optim.LBFGS (strong-Wolfe line search, one
    iteration per step), not the JAX package's optax.lbfgs (zoom line
    search, a preconditioned first step): the two take different paths, so
    the port is held to the objective's values and goldens, not to the
    trajectory. A step evaluates the objective and its gradient at its
    start (one evaluation more than optax), then 1 to LBFGS_MAX_LS times
    in the line search; a rejected trial step is retried with a shorter
    one, as optax's zoom search does."""
    p = _trainable(params)
    leaves = _leaves(p)

    def f(q):
        return quotient_loss(q, cfg, vb, head_weight)[0]

    def closure():
        opt.zero_grad()
        loss = f(p)
        loss.backward()
        return loss

    def fresh():
        # tolerance_grad 0: never stop early on a small gradient (optax
        # does not); tolerance_change bounds the line-search bracket.
        # max_eval: without it torch allows max_iter * 5 // 4 = 1
        # evaluation, which leaves the line search its first trial only
        return torch.optim.LBFGS(leaves, lr=1.0, max_iter=1,
                                 max_eval=1 + LBFGS_MAX_LS,
                                 history_size=memory_size,
                                 line_search_fn="strong_wolfe",
                                 tolerance_grad=0.0, tolerance_change=1e-12)

    def save_best():
        if best_save is not None:
            from ..io import checkpoint
            checkpoint.save(best_save,
                            {"params": ansatz.to_numpy_params(best_p)},
                            meta={"polish": "best-so-far"})

    opt = fresh()
    best_p, best_v = _snapshot(p), math.inf
    n_restarts = 0
    for i in range(steps):
        if val_fn is not None:
            # select on the validation value of the current iterate (before
            # the update), so the returned params scored best_v exactly
            with torch.no_grad():
                v = float(val_fn(p))
            if v < best_v:
                best_p, best_v = _snapshot(p), v
            elif math.isfinite(best_v) and v > best_v + restart_margin:
                # gamed basin: drop the poisoned curvature memory and
                # resume from the best-known iterate
                with torch.no_grad():
                    for t, b in zip(leaves, _leaves(best_p)):
                        t.copy_(b)
                opt = fresh()
                n_restarts += 1
                v = best_v
            value = opt.step(closure).item()
            if log_cb is not None and i % 25 == 0:
                log_cb(i, {"E_obj": value, "E_val": v, "E_best": best_v,
                           "restarts": n_restarts})
        else:
            cur = _snapshot(p)
            value = opt.step(closure).item()
            if value < best_v:
                best_p, best_v = cur, value
            if log_cb is not None and i % 25 == 0:
                log_cb(i, {"E_obj": value, "E_best": best_v})
        if best_save is not None and i % 100 == 99:
            save_best()
    # the loop scores iterates 0..steps-1; score the final iterate too
    if steps:
        with torch.no_grad():
            v = float(val_fn(p) if val_fn is not None else f(p))
        if v < best_v:
            best_p = _snapshot(p)
    return best_p


def _adam_minimize(params: dict, cfg: Config, vb: VBatch, steps: int,
                   head_weight: float, lr: float = 3e-3,
                   log_cb=None) -> dict:
    """Deterministic-Adam warmup on quotient_loss over a fixed batch: one
    gradient evaluation per step, with the staircase schedule
    lr * 0.5^floor(step / (steps // 4)). Logs every 100 steps and at the
    end."""
    p = _trainable(params)
    opt = torch.optim.Adam(_leaves(p), lr=lr)   # optax.adam's defaults
    sched = torch.optim.lr_scheduler.StepLR(
        opt, step_size=max(steps // 4, 1), gamma=0.5)
    for i in range(steps):
        opt.zero_grad()
        loss, _ = quotient_loss(p, cfg, vb, head_weight)
        loss.backward()
        opt.step()
        sched.step()
        done = i + 1
        if log_cb is not None and (done % 100 == 0 or done == steps):
            log_cb(done, {"E_adam": loss.item()})
    return _snapshot(p)


def _coprime_size(n: int, offset: int) -> int:
    """Smallest m >= n + offset with gcd(n, m) == 1: the dual-grid
    objective needs node sets with no common sub-lattice."""
    m = n + offset
    while math.gcd(n, m) != 1:
        m += 1
    return m


def _third(n: int, other: int, offset: int) -> int:
    """Validation-grid size coprime to both training grids' sizes."""
    m = n + offset
    while math.gcd(m, n) != 1 or math.gcd(m, other) != 1:
        m += 1
    return m


def dual_grid_vbatch(cfg: Config, n_r: int, n_xi: int, n_eta: int,
                     xi_span=None, dtype=None, device="cuda") -> VBatch:
    """The training batch of the polish: grid 1 (n_xi x n_eta) and grid 2
    (coprime sizes) as separate R rows; grid 1 is padded to grid 2's point
    count with zero-weight points at coordinate 1 (finite through 1/r)."""
    vb = spheroidal_vbatch(cfg, n_r=n_r, n_xi=n_xi, n_eta=n_eta,
                           xi_span=xi_span, dtype=dtype, device=device)
    vb2 = spheroidal_vbatch(cfg, n_r=n_r, n_xi=_coprime_size(n_xi, 17),
                            n_eta=_coprime_size(n_eta, 13),
                            xi_span=xi_span, dtype=dtype, device=device)
    pad = vb2.x.shape[1] - vb.x.shape[1]

    def po(a):
        return F.pad(a, (0, pad), value=1.0)

    return VBatch(torch.cat([po(vb.x), vb2.x]), torch.cat([po(vb.y), vb2.y]),
                  torch.cat([po(vb.z), vb2.z]),
                  torch.cat([F.pad(vb.w, (0, pad)), vb2.w]),
                  torch.cat([vb.r, vb2.r]))


def validation_vbatch(cfg: Config, n_r: int, n_xi: int, n_eta: int,
                      dual_grid: bool = True, xi_span=None, dtype=None,
                      device="cuda") -> VBatch:
    """The third, unseen grid of best-iterate selection: sizes coprime to
    both training grids."""
    oxi = _coprime_size(n_xi, 17) if dual_grid else n_xi
    oeta = _coprime_size(n_eta, 13) if dual_grid else n_eta
    return spheroidal_vbatch(cfg, n_r=n_r, n_xi=_third(n_xi, oxi, 29),
                             n_eta=_third(n_eta, oeta, 23), xi_span=xi_span,
                             dtype=dtype, device=device)


def polish_spheroidal(params: Optional[dict], cfg: Config, n_r: int = 77,
                      n_xi: int = 48, n_eta: int = 48, steps: int = 400,
                      xi_span: float | None = None, head_weight: float = 1.0,
                      dual_grid: bool = True, adam_steps: int = 0,
                      warmup_save: Optional[str] = None,
                      mesh=None, log_cb=None,
                      deflate_params: Optional[dict] = None,
                      memory_size: int = 15,
                      val_grid: bool = True,
                      best_save: Optional[str] = None,
                      device="cuda") -> dict:
    """Adam warmup + L-BFGS on the exact (quadrature) variational objective.

    ``dual_grid`` averages quotients over two coprime-sized grids per R, so
    a spike mode invisible to one grid is priced by the other;
    ``val_grid`` selects the best iterate on a third, unseen grid. ``params``
    None starts from the seeded GZ init (cfg.train.seed). Returns port
    params on ``device``. ``mesh`` and ``deflate_params`` are not ported
    yet and raise."""
    if mesh is not None:
        raise NotImplementedError("the mesh-sharded polish is not ported")
    if deflate_params is not None:
        raise NotImplementedError("deflation is not ported")
    dev = resolve_device(device)
    dtype = resolve_dtype(cfg.dtype)
    if params is None:
        params = ansatz.init_params(cfg.model, seed=cfg.train.seed,
                                    dtype=dtype, device=dev)
    params = ansatz.as_params(params, dtype, dev)
    if dtype == torch.float32 and steps:
        warnings.warn(
            "f32 L-BFGS on the quotient objective diverges after ~1k steps; "
            "best-iterate tracking limits the damage, but polish in f64 "
            "for production runs", stacklevel=2)
    if dual_grid:
        vb = dual_grid_vbatch(cfg, n_r, n_xi, n_eta, xi_span, dtype, dev)
    else:
        vb = spheroidal_vbatch(cfg, n_r=n_r, n_xi=n_xi, n_eta=n_eta,
                               xi_span=xi_span, dtype=dtype, device=dev)
    val_fn = None
    if val_grid and steps:
        vbv = validation_vbatch(cfg, n_r, n_xi, n_eta, dual_grid, xi_span,
                                dtype, dev)

        def val_fn(p):
            return quotient_loss(p, cfg, vbv, head_weight)[0]
    if adam_steps:
        params = _adam_minimize(params, cfg, vb, adam_steps, head_weight,
                                log_cb=log_cb)
        if warmup_save:
            from ..io import checkpoint
            checkpoint.save(warmup_save,
                            {"params": ansatz.to_numpy_params(params)},
                            meta={"polish": "spheroidal-adam-warmup"})
    return _lbfgs_minimize(params, cfg, vb, steps, head_weight, log_cb,
                           memory_size=memory_size, val_fn=val_fn,
                           best_save=best_save)
