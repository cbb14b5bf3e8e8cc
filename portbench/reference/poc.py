"""Plain PyTorch reference of the paper's own network (the reference code's
poc/main.py, arXiv:2211.04607) and of its residual objective.

Written from the published network (poc/main.py:223-355), with nuclei at
(+/-R, 0, 0), in the gerade sector:

    psi   = g(R) Lin_out(B) + N_LCAO,     N_LCAO = e^{-r1} + e^{-r2}
    B     = base(e^{-r1}, e^{-r2}) + base(e^{-r1'}, e^{-r2'})
    base  = sigmoid MLP 2 -> H -> H (two sigmoid layers)
    g(R)  = Linear(Hg -> 1)(sigmoid(Linear(1 -> Hg)(R)))
    E(R)  = sigmoid MLP 1 -> He -> He, then Linear(He -> 1)

where r1', r2' are the distances of the mirrored point (-x, y, z) and
Lin_out is Linear(H -> 1) with its bias. The exponent is fixed at 1 and
there is no Guillemin-Zener part. The residual objective (poc/main.py:341-
355) over a collocation batch:

    L = mean(((-lap psi / 2 - 1/r1 - 1/r2 - E(R)) psi)^2)
        + mean(psi^2 | r1 >= bc_cutoff) + mean(psi^2 | r2 >= bc_cutoff)

lap psi is taken by autograd (three second derivatives), sharing no
arithmetic with the program's forward-Laplacian kernels. Params are
``{name: {"w": (d_in, d_out), "b": (d_out,)}}``, y = x @ w + b.

Departures from poc/main.py:

- the batch is the benchmark's draw (``sampling.collocation``): x, y, z
  and R uniform from a seeded ``torch.Generator`` (poc draws unseeded),
  the nuclear clamp moving x to the cutoff, and the boundary set taken as
  two masks, r1 >= bc_cutoff and r2 >= bc_cutoff, one mean each, as the
  package takes poc's boundary penalty;
- poc's disabled anti-trivial term (poc/main.py:353-354) is left out.

``psi``'s keywords give the variants that the tests plant as faults: an
exponent alpha(R) in place of 1, a Guillemin-Zener second exponent b(R),
or no mirrored branch.
"""

from __future__ import annotations

import torch

from .ansatz import _radii, energy, potential
from .objectives import _grads


def gate(p, r):
    """g(R), the network-importance function."""
    g = torch.sigmoid(r[..., None] @ p["gate1"]["w"] + p["gate1"]["b"])
    return (g @ p["gate2"]["w"] + p["gate2"]["b"])[..., 0]


def psi(p, x, y, z, r, alpha=None, b=None, mirror=True):
    """psi at the points; ``alpha`` (an exponent in place of 1), ``b`` (the
    LCAO part becomes e^{-a r1 - b r2} + e^{-a r2 - b r1}) and ``mirror``
    False (B without its mirrored branch) are the planted variants."""
    a = 1.0 if alpha is None else alpha

    def base(xs):
        r1, r2 = _radii(xs, y, z, r)
        f = torch.stack([torch.exp(-a * r1), torch.exp(-a * r2)], -1)
        h = torch.sigmoid(f @ p["h1"]["w"] + p["h1"]["b"])
        return torch.sigmoid(h @ p["h2"]["w"] + p["h2"]["b"])

    big_b = base(x) + base(-x) if mirror else base(x)
    nn = (big_b @ p["out"]["w"] + p["out"]["b"])[..., 0]
    r1, r2 = _radii(x, y, z, r)
    if b is None:
        n_lcao = torch.exp(-a * r1) + torch.exp(-a * r2)
    else:
        n_lcao = torch.exp(-a * r1 - b * r2) + torch.exp(-a * r2 - b * r1)
    return gate(p, r) * nn + n_lcao


def psi_lap(p, x, y, z, r, **variant):
    """(psi, lap psi) at the points, differentiable in the params."""
    x, y, z = (t.detach().requires_grad_(True) for t in (x, y, z))
    v = psi(p, x, y, z, r, **variant)
    gx, gy, gz = torch.autograd.grad(v.sum(), (x, y, z), create_graph=True)
    lap = (torch.autograd.grad(gx.sum(), x, create_graph=True)[0]
           + torch.autograd.grad(gy.sum(), y, create_graph=True)[0]
           + torch.autograd.grad(gz.sum(), z, create_graph=True)[0])
    return v, lap


def residual(p, batch, keep=1.0, **variant):
    """(loss, [grad of each leaf]) of the residual objective on ``batch`` =
    (x, y, z, r, bc1, bc2), each (n,); ``keep`` < 1 keeps that share of
    the points, the first ones (a fault the comparison has to catch)."""
    n = max(1, int(batch[0].shape[0] * keep))
    x, y, z, r, bc1, bc2 = (t[:n] for t in batch)
    v, lap = psi_lap(p, x, y, z, r, **variant)
    res = -0.5 * lap + (potential(x, y, z, r) - energy(p, r)) * v
    v2 = v * v

    def bc(mask):
        return torch.sum(torch.where(mask, v2, 0.0)) / \
            torch.clamp(torch.sum(mask), min=1)

    loss = torch.mean(res * res) + bc(bc1) + bc(bc2)
    return float(loss.detach()), _grads(loss, p)
