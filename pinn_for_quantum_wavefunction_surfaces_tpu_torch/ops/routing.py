"""The one owner of the kernel choice: which code computes a model's
(psi, lap psi).

``kernel_of`` decides from the params and the config before any launch, as
the JAX package's ``loss_fn`` dispatches:

- K1 (``ops.pallas_separable``) carries the whole separable family, the
  excited states' node and transverse factors in its factor epilogue (the
  JAX package's Pallas kernel has no such epilogue: its
  ``losses.pallas_unsupported_reason`` names those models);
- K2 (``ops.pallas_train``) carries the symmetric family with a 2-input
  ``h1``, with or without the alpha(R) and GZ b(R) heads;
- K3 (``ops.pallas_residual``), forward only, carries the reference-parity
  model among those: no alpha(R) or b(R) head;
- None: no kernel carries the minimal family (keyed by the config: its
  params have the reference-parity tree) nor R-input models (keyed by the
  shape of ``h1``), in the JAX package or here; they take the
  forward-Laplacian pass ``ansatz.psi_fwdlap`` on every device.

Three entries, each asking ``kernel_of`` alone. ``psi_lap`` (the residual
trainers' losses) takes flat points, each with its own R, and evaluates the
R-only heads at every point (K2's through the R-heads kernel pair,
``ops/rheads.py``). ``psi_lap_rows`` (the variational quotients)
takes rows of points that share one R a row and evaluates the heads once a
row (K1's node heads too), broadcasting their values to the points; it
leaves E(R) out, which the quotient evaluates on the rows itself.
``psi_lap_forward`` (the scoring quotients, the deflation's frozen
references) is ``psi_lap`` forward only, with K3 for the reference-parity
model. The wrappers' JAX-named entries refuse the params they do not carry
through ``require``, which asks the same rule.
"""

from __future__ import annotations

import torch

from ..models import ansatz
from . import pallas_residual, pallas_separable, pallas_train, rheads
from .pallas_residual import psi_lap_pallas
from .pallas_separable import (psi_lap_train_separable, separable_heads,
                               separable_psi_lap)
from .pallas_train import psi_lap_train, train_heads, train_psi_lap

# R values at which the kernel routes evaluated their heads: "points" by
# ``psi_lap`` (one a point), "rows" by ``psi_lap_rows`` (one a row). Plain
# integers, added to in Python as the launch counts are.
head_evals = {"rows": 0, "points": 0}
# points that each entry sent to ``ansatz.psi_fwdlap`` (the models no kernel
# carries), counted the same way
fwdlap_points = {"psi_lap": 0, "psi_lap_rows": 0}
# every count of the kernel path: the wrappers' launches (the R-heads pair
# of ``psi_lap``'s K2 route apart from K1-K3's), the head evaluations and
# the forward-Laplacian points (a replayed CUDA graph adds back what its
# capture recorded, ``training/graphs.py``)
COUNTERS = (pallas_separable.launches, pallas_train.launches,
            pallas_residual.launches, rheads.launches, head_evals,
            fwdlap_points)

# the entry that each choice of ``kernel_of`` leads to, for the refusals
_ENTRY = {"K1": "ops.pallas_separable.psi_lap_train_separable",
          "K2": "ops.pallas_train.psi_lap_train",
          "K3": "ops.pallas_residual.psi_lap_pallas",
          None: "ansatz.psi_fwdlap (no kernel carries the minimal family or "
                "R-input models)"}


def kernel_of(params: dict, mcfg, forward_only: bool = False) -> str | None:
    """"K1", "K2" or "K3", the kernel that carries this model, or None for
    ``ansatz.psi_fwdlap``. K3 only for ``forward_only`` calls."""
    if "lam1" in params:
        return "K1"
    if mcfg.arch == "minimal" or params["h1"]["w"].shape[0] != 2:
        return None
    if forward_only and not ("alpha1" in params or "beta1" in params):
        return "K3"
    return "K2"


def require(params: dict, mcfg, kernel: str) -> None:
    """Raise NotImplementedError unless ``kernel_of`` gives these params to
    ``kernel`` (K3 on a forward-only call). The wrappers' entries ask it
    before they touch a tensor, so they refuse on every device, and their
    plain versions never compute another model's psi."""
    got = kernel_of(params, mcfg, forward_only=kernel == "K3")
    if got != kernel:
        raise NotImplementedError(
            f"{kernel} does not carry these params: they take {_ENTRY[got]}")


def psi_lap(params: dict, mcfg, x, y, z, r):
    """(psi, lap psi, E) of flat points, differentiable in the params,
    through the entry of ``kernel_of``'s kernel."""
    kernel = kernel_of(params, mcfg)
    if kernel is None:
        fwdlap_points["psi_lap"] += x.numel()
        s, e = ansatz.psi_fwdlap(params, mcfg, x, y, z, r)
        return s.v[..., 0], s.l[..., 0], e
    head_evals["points"] += r.numel()
    entry = psi_lap_train_separable if kernel == "K1" else psi_lap_train
    return entry(params, mcfg, x, y, z, r)


def _per_point(v, n_pts: int):
    """Row values ``v`` (n_r,) as the flat (n_r * n_pts,) values of the
    rows' points. Autograd sums the points' gradients back over each
    row."""
    return v[:, None].expand(-1, n_pts).reshape(-1)


def psi_lap_rows(params: dict, mcfg, x, y, z, r):
    """Flat (psi, lap psi) of the (n_r, n_pts) points ``x``, ``y``, ``z``
    whose row i lies at R = ``r[i]``, differentiable in the params; no E.
    The kernels' R-only heads (alpha, b, K1's node heads and K2's gate)
    run on the n_r values of ``r``, and so do their backward passes. The
    models that no kernel carries take ``ansatz.psi_fwdlap`` at every
    point, their network reading R."""
    n_r, n_pts = x.shape
    x, y, z = (t.reshape(-1) for t in (x, y, z))
    r_pts = _per_point(r, n_pts)
    kernel = kernel_of(params, mcfg)
    if kernel is None:
        fwdlap_points["psi_lap_rows"] += x.numel()
        s, _ = ansatz.psi_fwdlap(params, mcfg, x, y, z, r_pts)
        return s.v[..., 0], s.l[..., 0]
    head_evals["rows"] += n_r
    heads, part = ((separable_heads, separable_psi_lap) if kernel == "K1"
                   else (train_heads, train_psi_lap))
    per_point = tuple(None if h is None else _per_point(h, n_pts)
                      for h in heads(params, mcfg, r))
    return part(params, mcfg, per_point, x, y, z, r_pts)


def psi_lap_forward(params: dict, mcfg, x, y, z, r):
    """(psi, lap psi) of flat points, forward only: K3 for the
    reference-parity model, the rest as ``psi_lap`` routes them."""
    with torch.no_grad():
        if kernel_of(params, mcfg, forward_only=True) == "K3":
            return psi_lap_pallas(params, mcfg, x, y, z, r)
        return psi_lap(params, mcfg, x, y, z, r)[:2]
