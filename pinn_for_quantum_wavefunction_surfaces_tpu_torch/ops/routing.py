"""The one route from a model to the code that computes its (psi, lap psi).

Decided from the params and the config before any launch, as the JAX
package's ``loss_fn`` dispatches: the models that
``ansatz.kernel_unsupported_reason`` names (the minimal family, R-input
models) through the forward-Laplacian pass ``ansatz.psi_fwdlap`` on every
device, separable params through K1 (``ops.pallas_separable``; the excited
states' node and transverse factors in its factor epilogue), 2-input
symmetric params through K2 (``ops.pallas_train``). The trainers' losses and the scoring quotients all
come here; scoring alone sends reference-parity symmetric params to K3
first (``analysis.energy.psi_lap_forward``).

Two entries. ``psi_lap`` takes flat points, each with its own R, and
evaluates the R-only heads at every point. ``psi_lap_rows`` takes rows of
points that share one R a row (the quotient's batches) and evaluates the
heads once a row (K1's node heads too), broadcasting their values to the
points; it leaves E(R) out, which the quotient evaluates on the rows
itself. The models that no kernel carries take ``ansatz.psi_fwdlap`` at
every point from both.
"""

from __future__ import annotations

from ..models import ansatz
from .pallas_separable import (psi_lap_train_separable, separable_heads,
                               separable_psi_lap)
from .pallas_train import psi_lap_train, train_heads, train_psi_lap

# R values at which the kernel routes evaluated their heads: "points" by
# ``psi_lap`` (one a point), "rows" by ``psi_lap_rows`` (one a row). Plain
# integers, added to in Python as the launch counts are
# (``training/graphs.COUNTERS``).
head_evals = {"rows": 0, "points": 0}
# points that each entry sent to ``ansatz.psi_fwdlap`` (the models no kernel
# carries), counted the same way
fwdlap_points = {"psi_lap": 0, "psi_lap_rows": 0}


def psi_lap(params: dict, mcfg, x, y, z, r):
    """(psi, lap psi, E) of flat points, differentiable in the params: K1
    for separable params, K2 for symmetric ones, ``ansatz.psi_fwdlap`` for
    the models that no kernel carries."""
    if ansatz.kernel_unsupported_reason(params, mcfg) is not None:
        fwdlap_points["psi_lap"] += x.numel()
        s, e = ansatz.psi_fwdlap(params, mcfg, x, y, z, r)
        return s.v[..., 0], s.l[..., 0], e
    head_evals["points"] += r.numel()
    if "lam1" in params:
        return psi_lap_train_separable(params, mcfg, x, y, z, r)
    return psi_lap_train(params, mcfg, x, y, z, r)


def _per_point(v, n_pts: int):
    """Row values ``v`` (n_r,) as the flat (n_r * n_pts,) values of the
    rows' points. Autograd sums the points' gradients back over each
    row."""
    return v[:, None].expand(-1, n_pts).reshape(-1)


def psi_lap_rows(params: dict, mcfg, x, y, z, r):
    """Flat (psi, lap psi) of the (n_r, n_pts) points ``x``, ``y``, ``z``
    whose row i lies at R = ``r[i]``, differentiable in the params; no E.
    The kernels' R-only heads (alpha, b, K1's node heads and K2's gate)
    run on the n_r values of ``r``, and so do their backward passes. The models that no
    kernel carries take ``ansatz.psi_fwdlap`` at every point, their
    network reading R."""
    n_r, n_pts = x.shape
    x, y, z = (t.reshape(-1) for t in (x, y, z))
    r_pts = _per_point(r, n_pts)
    if ansatz.kernel_unsupported_reason(params, mcfg) is not None:
        fwdlap_points["psi_lap_rows"] += x.numel()
        s, _ = ansatz.psi_fwdlap(params, mcfg, x, y, z, r_pts)
        return s.v[..., 0], s.l[..., 0]
    head_evals["rows"] += n_r
    heads, kernel = ((separable_heads, separable_psi_lap) if "lam1" in params
                     else (train_heads, train_psi_lap))
    per_point = tuple(None if h is None else _per_point(h, n_pts)
                      for h in heads(params, mcfg, r))
    return kernel(params, mcfg, per_point, x, y, z, r_pts)
