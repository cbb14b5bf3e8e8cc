"""Variational training: minimise <psi|H|psi>/<psi|psi>.

The PyTorch counterpart of the JAX package's ``training/variational.py``.
The per-R Rayleigh quotients E_r = sum(w psi H psi) / sum(w psi^2) are
taken over a ``VBatch`` of (n_r, n_pts) points and weights, and the loss is
their mean plus an MSE term fitting the E(R) head. Three trainers:

- the spheroidal polish (``polish_spheroidal``): per-R prolate-spheroidal
  Gauss grids make the quotients exact (no Monte-Carlo noise); an Adam
  warmup, then L-BFGS with best-iterate selection on a third, independent
  grid;
- the Monte-Carlo trainer (``train_variational``): Adam on a fresh
  importance sample each step (``sample_vbatch``), with an EMA of the
  params;
- ``polish_lbfgs``: L-BFGS on one fixed importance sample.

psi and lap psi come from ``ops.routing.psi_lap_rows``, the kernels' R-only
heads evaluated once an R row. ``routing.kernel_of`` decides the route:
separable params, the excited states' node and m_abs factors included,
through K1, 2-input symmetric params through K2, so that on the card every
loss evaluation launches a forward kernel and every gradient a backward
kernel; the minimal family and R-input models through the
forward-Laplacian pass ``ansatz.psi_fwdlap``, as in the JAX package. The
JAX package's quotient takes the forward-Laplacian pass for symmetric
params and for excited separable ones; the kernels compute the same
function.

Excited states that are not the lowest of their sector are reached by
penalty deflation (``quotient_loss_deflated``) against frozen reference
states, whose rows are constants of the optimisation computed forward only
(``reference_states_on_batch``, through ``routing.psi_lap_forward``: a
separable reference, ground or excited, is one K1-fwd launch a grid on
the card).

With a mesh (``parallel.mesh``) the spheroidal polish shards its R rows
over the ranks (``polish_spheroidal(mesh=)``).

The JAX package scan-chunks the Monte-Carlo trainer and the polish's Adam
warmup. Here their steps (``MonteCarloTrainer``, ``AdamWarmup``) work on
static buffers, and on a CUDA device without a mesh each is captured once
as a CUDA graph and replayed every step (``training/graphs.py``); L-BFGS
stays eager. Both steps carry the spans and phase marks of
``utils/profiling.py`` (off by default; ``phases``).
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..device import resolve_device, resolve_dtype
from ..models import ansatz
from ..ops import operators, routing
from ..ops.sampling import sample_importance
from ..utils import profiling
from . import engine, graphs
from .lbfgs import LBFGS

# line-search evaluations an L-BFGS step may spend beyond its first: optax's
# zoom line search (the JAX package's optimiser) defaults to 20 steps
LBFGS_MAX_LS = 20


class VBatch(NamedTuple):
    x: torch.Tensor   # (n_r, n_pts)
    y: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor   # quadrature weights
    r: torch.Tensor   # (n_r,)


def _work(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the type of the quotients' pointwise products and sums: a
    bfloat16 value widened to float32 (exactly), float32 and float64 as
    they are. XLA keeps float32 between the ops of the JAX package's
    bfloat16 fusions; rounding H psi and each weighted product to bfloat16
    in turn put a quotient five bfloat16 units off."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _psi_hpsi_rows(params: dict, cfg: Config, vb: VBatch):
    """psi and H psi on the batch's (n_r, n_pts) rows, through the kernel
    of the params' family, its R-only heads evaluated once a row, or the
    forward-Laplacian pass (``routing.psi_lap_rows``), in the ``_work``
    type."""
    psi_f, lap_f = routing.psi_lap_rows(params, cfg.model, vb.x, vb.y, vb.z,
                                        vb.r)
    return _hpsi(cfg, vb, psi_f, lap_f)


def _hpsi(cfg: Config, vb: VBatch, psi_f, lap_f):
    """(psi, H psi) on the batch's rows from flat psi and lap psi, in the
    ``_work`` type."""
    n_r, n_pts = vb.x.shape
    psi = _work(psi_f).reshape(n_r, n_pts)
    lap = _work(lap_f).reshape(n_r, n_pts)
    v = operators.potential(cfg.model, _work(vb.x), _work(vb.y),
                            _work(vb.z), _work(vb.r)[:, None])
    return psi, -0.5 * lap + v * psi


def _row_mean(mesh):
    """Mean over the R rows of every rank: (sum, count) all-reduced over
    ``mesh`` (differentiably), or over this batch's rows without one."""
    ar = (lambda v: v) if mesh is None else mesh.sum

    def mean(v):
        n = ar(torch.full((), v.shape[0], dtype=v.dtype, device=v.device))
        return ar(torch.sum(v)) / n
    return mean


def quotient_loss(params: dict, cfg: Config, vb: VBatch,
                  head_weight: float = 1.0, mesh=None):
    """(loss, aux): mean Rayleigh quotient over the R rows + head MSE.
    With ``mesh`` the batch is this rank's rows; each row's quotient
    reduces here, and the means over R are all-reduced over the ranks.
    aux's ``e_r`` is this batch's rows."""
    mean = _row_mean(mesh)
    psi, hpsi = _psi_hpsi_rows(params, cfg, vb)
    w = _work(vb.w)
    num = torch.sum(w * psi * hpsi, dim=1)
    den = torch.sum(w * psi * psi, dim=1)
    e_r = (num / den).to(vb.w.dtype)
    e_head = ansatz.energy(params, vb.r)
    l_head = mean((e_head - e_r.detach()) ** 2)
    e_mean = mean(e_r)
    loss = e_mean + head_weight * l_head
    return loss, {"e_mean": e_mean, "l_head": l_head, "e_r": e_r}


# Weight on the span{phi_i}-contamination term of the deflated loss, in Ha
# per unit norm fraction. It must exceed the largest spectral gap
# E_target - E_1 on the surface (1ssg -> 2ssg at R = 0.2 is ~1.44 Ha): near
# zero contamination the energy gained by mixing in a lower state and the
# penalty are both linear in the contamination, so for W above the gap the
# optimum has exactly zero contamination.
OVERLAP_PENALTY = 4.0


def quotient_loss_deflated(params: dict, cfg: Config, vb: VBatch,
                           psi0: torch.Tensor, hpsi0: torch.Tensor,
                           head_weight: float = 1.0, mesh=None):
    """(loss, aux): the penalty-deflated Rayleigh quotient per R row,
    targeting the lowest state of the sector orthogonal to the frozen
    references phi_i:

        q_r     = <psi H psi> / <psi psi>
        contam  = sum_i <psi, phi_i>^2 / (<phi_i phi_i> <psi psi>)
        loss    = mean(q_r) + OVERLAP_PENALTY * mean(contam) + head term

    The plain quotient stays bounded below on any grid and the penalty
    divides by nothing that can vanish; a projected quotient (dividing by
    psi's perpendicular norm) has a runaway basin, which the JAX package
    observed. psi and H psi follow quotient_loss's routing (the JAX
    package takes the forward-Laplacian pass whatever the family).

    psi0, hpsi0: (n_rows, n_pts), or (k, n_rows, n_pts) for k references
    row-orthogonalised by ``reference_states_on_batch`` (the contamination
    sum assumes an orthogonal stack), on the rows of ``vb``. hpsi0 is kept
    for the JAX package's signature and unused. ``mesh``: as in
    quotient_loss (the references are this rank's rows too). While tracing
    is on, the sums after psi and H psi are the step's ``deflate`` phase
    (``profiling.mark``)."""
    del hpsi0
    mean = _row_mean(mesh)
    psi, hpsi = _psi_hpsi_rows(params, cfg, vb)
    profiling.mark("deflate")
    if psi0.ndim == 2:
        psi0 = psi0[None]                          # (k=1, rows, pts)
    psi0, w = _work(psi0), _work(vb.w)
    n_ = torch.sum(w * psi * psi, dim=1)
    s_ = torch.sum(w * psi * hpsi, dim=1)
    o = torch.sum(w * psi * psi0, dim=2)           # (k, rows) <psi, phi_i>
    n0 = torch.sum(w * psi0 * psi0, dim=2)         # (k, rows)
    q_r = (s_ / n_).to(vb.w.dtype)
    # (rows,) in [0, 1]
    contam = (torch.sum(o * o / n0, dim=0) / n_).to(vb.w.dtype)
    e_head = ansatz.energy(params, vb.r)
    l_head = mean((e_head - q_r.detach()) ** 2)
    e_mean = mean(q_r)
    loss = e_mean + head_weight * l_head + OVERLAP_PENALTY * mean(contam)
    c_max = torch.max(contam) if mesh is None else mesh.max(torch.max(contam))
    return loss, {"e_mean": e_mean, "l_head": l_head, "e_r": q_r,
                  "perp_frac": 1.0 - c_max, "contam": c_max}


def reference_state_on_batch(params0: dict, cfg: Config, vb: VBatch):
    """(psi0, hpsi0) of a frozen reference state on the batch's rows: the
    constant inputs of quotient_loss_deflated, computed forward only (no
    gradient flows through them). Evaluated under ``cfg``'s model (the
    target's: its parity and m_abs) through ``routing.psi_lap_forward``,
    so a separable reference, ground or excited, is one K1-fwd launch on
    the card (the excited one K1's factor instantiation)."""
    n_r, n_pts = vb.x.shape
    rr = vb.r[:, None].expand(n_r, n_pts).reshape(-1)
    psi_f, lap_f = routing.psi_lap_forward(
        params0, cfg.model, vb.x.reshape(-1), vb.y.reshape(-1),
        vb.z.reshape(-1), rr)
    psi0, hpsi0 = _hpsi(cfg, vb, psi_f, lap_f)
    return psi0.detach(), hpsi0.detach()


def reference_states_on_batch(params_list, cfg: Config, vb: VBatch):
    """Stacked (k, rows, pts) reference states, row-orthogonalised by
    Gram-Schmidt in the quadrature inner product (H phi follows by
    linearity), so quotient_loss_deflated's sum has no cross terms: k
    references target the (k+1)-th state of the sector."""
    ps, hs = zip(*(reference_state_on_batch(p, cfg, vb)
                   for p in params_list))
    ps, hs = list(ps), list(hs)
    w = _work(vb.w)
    for i in range(1, len(ps)):
        for j in range(i):
            coef = (torch.sum(w * ps[i] * ps[j], dim=1)
                    / torch.sum(w * ps[j] * ps[j], dim=1))[:, None]
            ps[i] = ps[i] - coef * ps[j]
            hs[i] = hs[i] - coef * hs[j]
    return torch.stack(ps), torch.stack(hs)


def polish_objective(cfg: Config, vb: VBatch, deflate_params=None,
                     mesh=None):
    """The polish's objective, ``loss_fn(params, cfg, vb, head_weight) ->
    (loss, aux)`` as ``AdamWarmup`` and ``_lbfgs_minimize`` call it:
    quotient_loss, or, with ``deflate_params`` (frozen reference-state
    params of the same sector, port params or numpy trees, a dict for one
    or a list for k), quotient_loss_deflated against the references' rows
    on ``vb``. The rows are computed here once (the span
    ``pinn.references``), the references in the batch's type and on its
    device. ``mesh``: as in quotient_loss; ``vb`` is this rank's rows."""
    if deflate_params is None:
        def loss_fn(p, cfg_, vb_, hw):
            return quotient_loss(p, cfg_, vb_, hw, mesh=mesh)
        return loss_fn
    refs = (deflate_params if isinstance(deflate_params, (list, tuple))
            else [deflate_params])
    frozen = [ansatz.as_params(p, vb.x.dtype, vb.x.device) for p in refs]
    with profiling.annotate("references"):
        psi0, hpsi0 = reference_states_on_batch(frozen, cfg, vb)

    def loss_fn(p, cfg_, vb_, hw):
        return quotient_loss_deflated(p, cfg_, vb_, psi0, hpsi0, hw,
                                      mesh=mesh)
    return loss_fn


def contamination_curve(params: dict, refs, cfg: Config, r_values,
                        n_xi: int = 64, n_eta: int = 64) -> np.ndarray:
    """Per-R norm fraction of psi inside span{refs}: the excited-state
    certificate, on an n_xi x n_eta spheroidal grid independent of the
    training grids. ``params`` are port params (their device and dtype
    rule); ``refs`` port params or numpy trees."""
    like = params["e1"]["w"]
    refs = [ansatz.as_params(p, like.dtype, like.device) for p in refs]
    vb = spheroidal_vbatch(cfg, n_xi=n_xi, n_eta=n_eta,
                           r_values=np.asarray(r_values, np.float64),
                           dtype=like.dtype, device=like.device)
    ps, _ = reference_states_on_batch(refs, cfg, vb)
    n_r, n_pts = vb.x.shape
    rr = vb.r[:, None].expand(n_r, n_pts).reshape(-1)
    with torch.no_grad():
        psi, _ = ansatz.psi(params, cfg.model, vb.x.reshape(-1),
                            vb.y.reshape(-1), vb.z.reshape(-1), rr)
        psi, w = _work(psi.reshape(n_r, n_pts)), _work(vb.w)
        n_ = torch.sum(w * psi * psi, dim=1)
        o = torch.sum(w * psi * ps, dim=2)
        n0 = torch.sum(w * ps * ps, dim=2)
        return (torch.sum(o * o / n0, dim=0) / n_).cpu().numpy()


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


def _backward(loss: torch.Tensor, leaves, mesh) -> None:
    """Gradients of the global ``loss`` in the leaves' ``.grad``: with
    ``mesh``, each rank differentiates its 1/N share and the shares are
    summed over the ranks."""
    if mesh is None:
        loss.backward()
        return
    (loss / mesh.size).backward()
    mesh.sum_grads(leaves)


def _snapshot(params: dict) -> dict:
    return {k: {f: t.detach().clone() for f, t in v.items()}
            for k, v in params.items()}


def _lbfgs_minimize(params: dict, cfg: Config, vb: VBatch, steps: int,
                    head_weight: float, log_cb=None, loss_fn=None,
                    memory_size: int = 15, val_fn=None,
                    restart_margin: float = 1e-3,
                    best_save: Optional[str] = None, mesh=None) -> dict:
    """L-BFGS on ``loss_fn`` (default quotient_loss) over a fixed batch.

    Returns the BEST iterate, not the last (late steps can overshoot).
    ``val_fn`` (params -> scalar): the best iterate is selected by this
    independent-grid value instead of the training objective; when it
    drifts ``restart_margin`` (Ha) above the running best, the optimiser
    restarts from the best iterate with fresh curvature memory.
    ``best_save``: checkpoint the running best every 100 steps.
    ``mesh``: ``loss_fn`` and ``val_fn`` give global values (all-reduced
    over the ranks), and the gradient is summed over the ranks
    (``_backward``); every rank then takes the same steps.

    The optimiser is ``lbfgs.LBFGS``: optax.lbfgs's curvature memory (the
    JAX package's optimiser) on torch's strong-Wolfe line search, not
    optax's zoom search, so the two packages take different paths and the
    port is held to the objective's values and goldens, not to the
    trajectory. A step evaluates the objective and its gradient 1 to
    LBFGS_MAX_LS times in its line search (a rejected trial step is
    retried with a shorter one, as optax's zoom search does), and once
    more at its start only after a restart."""
    loss_fn = quotient_loss if loss_fn is None else loss_fn
    p = _trainable(params)
    leaves = _leaves(p)

    def f(q):
        return loss_fn(q, cfg, vb, head_weight)[0]

    def closure():
        opt.zero_grad()
        loss = f(p)
        _backward(loss, leaves, mesh)
        return loss

    def fresh():
        return LBFGS(leaves, memory_size=memory_size, max_ls=LBFGS_MAX_LS)

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
            value = opt.step(closure)
            if log_cb is not None and i % 25 == 0:
                log_cb(i, {"E_obj": value, "E_val": v, "E_best": best_v,
                           "restarts": n_restarts})
        else:
            cur = _snapshot(p)
            value = opt.step(closure)
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


def warmup_lr(lr: float, steps: int, i: int) -> float:
    """The Adam warmup's rate at step ``i`` (0-based): optax's staircase
    exponential_decay(lr, steps // 4, 0.5), lr * 0.5^floor(i / (steps //
    4)), in float32 as optax evaluates it on its int32 step count, whatever
    the params' type."""
    f32 = np.float32
    return float(f32(lr) * f32(0.5) ** f32(i // max(steps // 4, 1)))


class AdamWarmup:
    """The polish's deterministic-Adam warmup as a graph-ready step (the
    JAX package scan-chunks it): one gradient evaluation of ``loss_fn`` on
    the fixed batch and one Adam update a call, on static buffers (the
    params' flat vector, Adam's moments, ``loss``: the objective of the
    params before the update). ``graphs.StepGraph`` captures it on a CUDA
    device without a mesh when ``graph`` is set. ``mesh``: as in
    _lbfgs_minimize."""

    def __init__(self, params: dict, cfg: Config, vb: VBatch, steps: int,
                 head_weight: float, lr: float = 3e-3, loss_fn=None,
                 mesh=None, graph: bool = True):
        self.cfg, self.vb, self.steps = cfg, vb, steps
        self.head_weight, self.lr0, self.mesh = head_weight, lr, mesh
        self.loss_fn = quotient_loss if loss_fn is None else loss_fn
        self.layout = engine._Layout(params, frozenset())
        leaf = _leaves(params)[0]
        self.flat = self.layout.flat(params, leaf.dtype,
                                     leaf.device).requires_grad_(True)
        self.opt = engine.Adam(self.flat, lr=lr)   # optax.adam's defaults
        self.loss = None
        self.done = 0
        self._step = graphs.StepGraph(
            self._eval_and_update,
            graphs.captures(leaf.device, mesh, graph))

    def params(self) -> dict:
        """A copy of the current params."""
        return self.layout.tree(self.flat.detach().clone())

    def advance(self) -> None:
        with profiling.annotate("advance", self.done):
            self.opt.set_lr(warmup_lr(self.lr0, self.steps, self.done))
            with profiling.annotate("step"):
                self._step()
            self.done += 1

    def phases(self) -> dict:
        """{phase: device ms} of the last step while tracing is on (else
        {}): ``forward``, ``backward``, ``update`` (the loss kept, Adam),
        and ``deflate`` between forward and backward under a deflated
        objective (``quotient_loss_deflated``)."""
        return self._step.phases()

    def _eval_and_update(self) -> None:
        self.flat.grad = None
        profiling.mark("forward")
        loss, _ = self.loss_fn(self.layout.tree(self.flat), self.cfg,
                               self.vb, self.head_weight)
        profiling.mark("backward")
        _backward(loss, [self.flat], self.mesh)
        profiling.mark("update")
        self.loss = graphs.keep(self.loss, loss)
        self.opt.step(self.flat.grad)


def _adam_minimize(params: dict, cfg: Config, vb: VBatch, steps: int,
                   head_weight: float, lr: float = 3e-3,
                   log_cb=None, loss_fn=None, mesh=None,
                   graph: bool = True) -> dict:
    """Deterministic-Adam warmup on ``loss_fn`` (default quotient_loss) over
    a fixed batch (``AdamWarmup``): one gradient evaluation per step, with
    the staircase schedule ``warmup_lr``. Logs every 100 steps and at the
    end, the host's only reads of the device. ``mesh``: as in
    _lbfgs_minimize; ``graph``: capture the step (``AdamWarmup``)."""
    warm = AdamWarmup(params, cfg, vb, steps, head_weight, lr, loss_fn,
                      mesh, graph)
    for _ in range(steps):
        warm.advance()
        done = warm.done
        if log_cb is not None and (done % 100 == 0 or done == steps):
            with profiling.annotate("read"):
                loss = warm.loss.item()
            log_cb(done, {"E_adam": loss})
    return warm.params()


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
                      deflate_params=None,
                      memory_size: int = 15,
                      val_grid: bool = True,
                      best_save: Optional[str] = None,
                      device="cuda", graph: bool = True) -> dict:
    """Adam warmup + L-BFGS on the exact (quadrature) variational objective.

    ``dual_grid`` averages quotients over two coprime-sized grids per R, so
    a spike mode invisible to one grid is priced by the other;
    ``val_grid`` selects the best iterate on a third, unseen grid. ``params``
    None starts from the seeded GZ init (cfg.train.seed). Returns port
    params on ``device``.

    ``deflate_params``: frozen reference-state params of the same sector
    (port params or numpy trees), a dict for one or a list for k; the
    objective becomes quotient_loss_deflated, targeting the sector's
    (k+1)-th state. The references' rows are computed once on the training
    grid and once on the validation grid (``polish_objective``).

    ``mesh`` (``parallel.mesh.Mesh``): the polish runs on every rank of it,
    each on its own device, as the JAX package shards it: n_r rounds up to
    a multiple of the mesh size (unless ``cfg.domain.fixed_r`` is set); the
    training batch's, the validation grid's and the references' R rows
    split over the ranks in contiguous blocks; each row's quotient reduces
    on its rank, and the means over R and the gradient are all-reduced.
    Every rank takes the same steps on the same values, so the params stay
    equal bit for bit on every rank. Only rank 0 logs and writes
    ``warmup_save`` and ``best_save``.

    ``graph``: the Adam warmup's step is captured as a CUDA graph on a CUDA
    device without a mesh (``AdamWarmup``); L-BFGS stays eager."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    dtype = resolve_dtype(cfg.dtype)
    if mesh is not None and cfg.domain.fixed_r is None:
        # a few more R rows only densify the surface
        n_r = -(-n_r // mesh.size) * mesh.size
    if mesh is not None and not mesh.is_coordinator:
        log_cb = warmup_save = best_save = None
    if params is None:
        params = ansatz.init_params(cfg.model, seed=cfg.train.seed,
                                    dtype=dtype, device=dev)
    params = ansatz.as_params(params, dtype, dev)
    if dtype == torch.float32 and steps:
        warnings.warn(
            "f32 L-BFGS on the quotient objective diverges after ~1k steps; "
            "best-iterate tracking limits the damage, but polish in f64 "
            "for production runs", stacklevel=2)

    def rows(batch: VBatch) -> VBatch:
        """This rank's block of the batch's R rows."""
        if mesh is None:
            return batch
        sl = mesh.block(batch.r.shape[0], "R rows")
        return VBatch(*(a[sl] for a in batch))

    if dual_grid:
        vb = dual_grid_vbatch(cfg, n_r, n_xi, n_eta, xi_span, dtype, dev)
    else:
        vb = spheroidal_vbatch(cfg, n_r=n_r, n_xi=n_xi, n_eta=n_eta,
                               xi_span=xi_span, dtype=dtype, device=dev)
    vb = rows(vb)
    # the references' rows are row-wise: on this rank's rows they are the
    # (k, rows, pts) stack's block along axis 1
    loss_fn = polish_objective(cfg, vb, deflate_params, mesh)
    val_fn = None
    if val_grid and steps:
        vbv = rows(validation_vbatch(cfg, n_r, n_xi, n_eta, dual_grid,
                                     xi_span, dtype, dev))
        # the validation grid's own reference rows
        val_loss = polish_objective(cfg, vbv, deflate_params, mesh)

        def val_fn(p):
            return val_loss(p, cfg, vbv, head_weight)[0]
    if adam_steps:
        params = _adam_minimize(params, cfg, vb, adam_steps, head_weight,
                                log_cb=log_cb, loss_fn=loss_fn, mesh=mesh,
                                graph=graph)
        if warmup_save:
            from ..io import checkpoint
            checkpoint.save(warmup_save,
                            {"params": ansatz.to_numpy_params(params)},
                            meta={"polish": "spheroidal-adam-warmup"})
    return _lbfgs_minimize(params, cfg, vb, steps, head_weight, log_cb,
                           loss_fn=loss_fn, memory_size=memory_size,
                           val_fn=val_fn, best_save=best_save, mesh=mesh)


# ---------------------------------------------------------------------------
# Monte-Carlo objective: importance samples drawn afresh


def sample_vbatch(gen: torch.Generator, cfg: Config, n_r: int, n_pts: int,
                  dtype=None, antithetic: bool = False,
                  stratified: bool = False, device=None) -> VBatch:
    """Draw the (R, points) batch of the Monte-Carlo quotient estimator from
    ``gen`` on ``device`` (default: the generator's): n_r half-distances,
    and per R n_pts importance samples with their exact weights
    (ops.sampling.sample_importance). Both options reduce the variance
    without changing an expectation: ``stratified`` takes one R from each
    of n_r equal strata of [r_lo, r_hi] instead of n_r uniform draws;
    ``antithetic`` pairs the shells' radii."""
    dtype = resolve_dtype(cfg.dtype if dtype is None else dtype)
    dev = resolve_device(gen.device if device is None else device)
    dom = cfg.domain
    if dom.fixed_r is not None:
        r = torch.full((n_r,), dom.fixed_r, dtype=dtype, device=dev)
    else:
        u = torch.rand(n_r, generator=gen, dtype=dtype, device=dev)
        if stratified:
            u = (torch.arange(n_r, dtype=dtype, device=dev) + u) / n_r
        r = dom.r_lo + (dom.r_hi - dom.r_lo) * u
    x, y, z, w = sample_importance(gen, cfg, r, n_pts, dtype,
                                   antithetic=antithetic, device=dev)
    return VBatch(x, y, z, w, r)


def polish_lbfgs(params: Optional[dict], cfg: Config, n_r: int = 64,
                 n_pts: int = 32768, steps: int = 300,
                 gen: Optional[torch.Generator] = None,
                 head_weight: float = 1.0, log_cb=None,
                 device="cuda") -> dict:
    """Full-batch L-BFGS on one fixed importance sample: n_r half-distances
    evenly spaced over [r_lo, r_hi], n_pts points each, drawn from ``gen``
    (default: seeded with ``cfg.train.seed + 7``). Returns the best iterate
    (port params on ``device``). ``params`` None starts from the seeded
    init."""
    dev = resolve_device(device)
    dtype = resolve_dtype(cfg.dtype)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.train.seed + 7)
    if params is None:
        params = ansatz.init_params(cfg.model, seed=cfg.train.seed,
                                    dtype=dtype, device=dev)
    params = ansatz.as_params(params, dtype, dev)
    dom = cfg.domain
    r = torch.linspace(dom.r_lo, dom.r_hi, n_r, dtype=dtype, device=dev)
    x, y, z, w = sample_importance(gen, cfg, r, n_pts, dtype, device=dev)
    return _lbfgs_minimize(params, cfg, VBatch(x, y, z, w, r), steps,
                           head_weight, log_cb)


class VState(NamedTuple):
    step: int
    params: dict          # port params (views of the trained vector)
    opt: engine.Adam
    ema_params: dict
    generator: torch.Generator


class MonteCarloTrainer:
    """The Monte-Carlo trainer's live state as a graph-ready step: a fresh
    ``sample_vbatch`` from ``gen`` each step, its quotient_loss and
    gradient, an Adam update and the EMA, on static buffers (the params'
    flat vector, Adam's moments, ``ema_flat``, the batch ``vb`` and the
    history ``row`` (Ltot, E_mean, l_head) of the last step).
    ``graphs.StepGraph`` captures the step, the draw included (the
    generator registered), on a CUDA device when ``graph`` is set."""

    def __init__(self, cfg: Config, params: dict, n_r: int, n_pts: int,
                 gen: torch.Generator, ema_decay: float = 0.999,
                 antithetic: bool = False, stratified: bool = False,
                 device="cuda", graph: bool = True):
        dev = resolve_device(device)
        dtype = resolve_dtype(cfg.dtype)
        self.cfg, self.n_r, self.n_pts, self.gen = cfg, n_r, n_pts, gen
        self.antithetic, self.stratified = antithetic, stratified
        self.ema_decay, self.device = ema_decay, dev
        params = ansatz.as_params(params, dtype, dev)
        self.layout = engine._Layout(params, frozenset())
        self.flat = self.layout.flat(params, dtype, dev).requires_grad_(True)
        self.opt = engine.make_optimizer(cfg, self.flat)
        self.ema_flat = self.flat.detach().clone()
        # in the loss type (float32 for bfloat16 params: numpy has no
        # bfloat16)
        self.row = torch.zeros(3, dtype=torch.promote_types(
            dtype, torch.float32), device=dev)
        self.vb = None
        self.step = 0
        self._step = graphs.StepGraph(self._train_step,
                                      graphs.captures(dev, None, graph),
                                      generators=(gen,))

    def advance(self) -> None:
        with profiling.annotate("advance", self.step):
            self.opt.set_lr(engine.learning_rate(self.cfg, self.step))
            with profiling.annotate("step"):
                self._step()
            self.step += 1

    def phases(self) -> dict:
        """{phase: device ms} of the last step while tracing is on (else
        {}): ``sample`` (the draw), ``forward``, ``backward``, ``update``
        (history row, Adam, EMA)."""
        return self._step.phases()

    def _train_step(self) -> None:
        profiling.mark("sample")
        self.vb = graphs.keep(self.vb, sample_vbatch(
            self.gen, self.cfg, self.n_r, self.n_pts,
            antithetic=self.antithetic, stratified=self.stratified,
            device=self.device))
        self.flat.grad = None
        profiling.mark("forward")
        loss, aux = quotient_loss(self.layout.tree(self.flat), self.cfg,
                                  self.vb)
        profiling.mark("backward")
        loss.backward()
        profiling.mark("update")
        with torch.no_grad():
            self.row.copy_(torch.stack([loss, aux["e_mean"],
                                        aux["l_head"]]))
        self.opt.step(self.flat.grad)
        with torch.no_grad():
            d = self.ema_decay
            self.ema_flat.copy_(d * self.ema_flat + (1.0 - d) * self.flat)


def train_variational(cfg: Config, params: Optional[dict] = None,
                      n_r: int = 32, n_pts: int = 4096,
                      epochs: Optional[int] = None,
                      lr: Optional[float] = None,
                      ema_decay: float = 0.999,
                      gen: Optional[torch.Generator] = None,
                      antithetic: bool = False, stratified: bool = False,
                      log_cb=None, device="cuda",
                      graph: bool = True) -> engine.TrainResult:
    """The Monte-Carlo variational trainer: Adam on quotient_loss over a
    fresh ``sample_vbatch`` each step, with the rate ``lr`` (default
    ``cfg.train.lr``) under ``cfg.train.lr_schedule``, and an exponential
    moving average (``ema_decay``) of the params that starts at the initial
    ones. Draws come from ``gen`` (default: seeded with
    ``cfg.train.seed``); ``params`` None starts from the seeded init.
    ``graph``: capture the step (the draw included) as a CUDA graph on a
    CUDA device (``MonteCarloTrainer``); False runs it eagerly.

    The host reads the device every ``cfg.train.scan_chunk`` steps and then
    calls ``log_cb(step, {"E_mean", "l_head"})``. The history holds the JAX
    package's keys per step: Ltot the objective, Lpde its quotient part
    (Ltot - l_head), Lbc the head term, Energy the mean quotient."""
    t = cfg.train
    dev = resolve_device(device)
    dtype = resolve_dtype(cfg.dtype)
    epochs = epochs or t.epochs
    if lr is not None:
        cfg = cfg.replace(train=dataclasses.replace(t, lr=lr))
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(t.seed)
    if params is None:
        params = ansatz.init_params(cfg.model, seed=t.seed, dtype=dtype,
                                    device=dev)
    mc = MonteCarloTrainer(cfg, params, n_r, n_pts, gen, ema_decay,
                           antithetic, stratified, dev, graph)
    chunks = []
    t0 = time.perf_counter()
    while mc.step < epochs:
        n = min(t.scan_chunk, epochs - mc.step)
        hist = torch.empty((n, 3), dtype=mc.row.dtype, device=dev)
        for j in range(n):
            mc.advance()
            hist[j].copy_(mc.row)
        with profiling.annotate("read"):
            chunks.append(hist.cpu().numpy())
        if log_cb is not None:
            last = chunks[-1][-1]
            log_cb(mc.step, {"E_mean": float(last[1]),
                             "l_head": float(last[2])})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    runtime = time.perf_counter() - t0
    h = np.concatenate(chunks)
    # the quotient objective has no pde/bc split: Lpde carries its
    # quotient part and Lbc the head term, as in the JAX package
    history = {"Ltot": h[:, 0], "Lpde": h[:, 0] - h[:, 2], "Lbc": h[:, 2],
               "Energy": h[:, 1]}
    layout = mc.layout
    final = ansatz.to_numpy_params(layout.tree(mc.flat.detach()))
    ema = ansatz.to_numpy_params(layout.tree(mc.ema_flat))
    return engine.TrainResult(
        state=VState(mc.step, layout.tree(mc.flat.detach()), mc.opt,
                     layout.tree(mc.ema_flat), gen),
        params=final, best_params=final,
        best_loss=float(history["Ltot"][-1]), history=history,
        runtime_s=runtime,
        points_per_sec=epochs * n_r * n_pts / max(runtime, 1e-9),
        ema_params=ema)
