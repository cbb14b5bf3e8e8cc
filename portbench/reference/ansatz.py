"""Plain PyTorch reference of the two families' psi, E(R) and lap psi.

Written from the ansatz's equations (arXiv:2211.04607 and the package's
model description), with nuclei at (+/-R, 0, 0) and the gerade sector:

- separable-spheroidal: psi = Phi_GZ exp(3 tanh((l(t, R/4) + m(eta^2,
  R/4)) / 3)), Phi_GZ = e^{-a r1 - b r2} + e^{-a r2 - b r1}, t = e^{R -
  (r1 + r2)/2}, eta^2 = ((r1 - r2) / 2R)^2, l and m tanh MLPs 2 -> H -> H
  -> 1;
- symmetric with GZ and a trainable exponent: psi = g(R) Lin_out(base(f1,
  f2) + base(f1m, f2m)) + Phi_GZ, f = e^{-alpha r}, the mirror x -> -x,
  base a sigmoid MLP 2 -> H -> H, g(R) a sigmoid gate 1 -> Hg -> 1;

with alpha(R) = 1.5 + 0.75 tanh(head), b(R) = 0.75 (1 + tanh(head)), heads
1 -> Ha -> 1 (sigmoid), and E(R) a sigmoid MLP 1 -> He -> He -> 1.

lap psi is taken by autograd, three second derivatives, and not by the
forward-Laplacian propagation that the program's kernels compute: the two
share no arithmetic. Params are ``{name: {"w": (d_in, d_out), "b":
(d_out,)}}``, y = x @ w + b.
"""

from __future__ import annotations

import torch

LOG_CORR_CAP = 3.0


def _head(p, name, r):
    a = torch.sigmoid(r[..., None] @ p[name + "1"]["w"] + p[name + "1"]["b"])
    return (a @ p[name + "2"]["w"] + p[name + "2"]["b"])[..., 0]


def energy(p, r):
    """E(R)."""
    y = torch.sigmoid(r[..., None] @ p["e1"]["w"] + p["e1"]["b"])
    y = torch.sigmoid(y @ p["e2"]["w"] + p["e2"]["b"])
    return (y @ p["eout"]["w"] + p["eout"]["b"])[..., 0]


def exponents(p, r):
    """(alpha(R), b(R)) of the gerade sector."""
    alpha = 1.5 + 0.75 * torch.tanh(_head(p, "alpha", r))
    beta = 0.75 * (1.0 + torch.tanh(_head(p, "beta", r)))
    return alpha, beta


def _radii(x, y, z, r):
    r1 = torch.sqrt((x - r) ** 2 + y ** 2 + z ** 2)
    r2 = torch.sqrt((x + r) ** 2 + y ** 2 + z ** 2)
    return r1, r2


def psi_separable(p, x, y, z, r):
    r1, r2 = _radii(x, y, z, r)
    a, b = exponents(p, r)
    phi = torch.exp(-a * r1 - b * r2) + torch.exp(-a * r2 - b * r1)
    t = torch.exp(r - 0.5 * (r1 + r2))
    eta2 = (0.5 * (r1 - r2) / r) ** 2
    rf = 0.25 * r

    def mlp(s, k):
        h = torch.tanh(torch.stack([s, rf], -1) @ p[k + "1"]["w"]
                       + p[k + "1"]["b"])
        h = torch.tanh(h @ p[k + "2"]["w"] + p[k + "2"]["b"])
        return (h @ p[k + "out"]["w"] + p[k + "out"]["b"])[..., 0]

    c = LOG_CORR_CAP
    return phi * torch.exp(c * torch.tanh((mlp(t, "lam") + mlp(eta2, "mu"))
                                          / c))


def psi_symmetric(p, x, y, z, r):
    alpha, beta = exponents(p, r)
    g = torch.sigmoid(r[..., None] @ p["gate1"]["w"] + p["gate1"]["b"])
    g = (g @ p["gate2"]["w"] + p["gate2"]["b"])[..., 0]

    def base(xs):
        r1, r2 = _radii(xs, y, z, r)
        f = torch.stack([torch.exp(-alpha * r1), torch.exp(-alpha * r2)], -1)
        h = torch.sigmoid(f @ p["h1"]["w"] + p["h1"]["b"])
        return torch.sigmoid(h @ p["h2"]["w"] + p["h2"]["b"])

    nn = (base(x) + base(-x)) @ p["out"]["w"] + p["out"]["b"]
    r1, r2 = _radii(x, y, z, r)
    gz = (torch.exp(-alpha * r1 - beta * r2)
          + torch.exp(-alpha * r2 - beta * r1))
    return nn[..., 0] * g + gz


PSI = {"separable": psi_separable, "symmetric": psi_symmetric}


def psi_lap(family: str, p, x, y, z, r):
    """(psi, lap psi) at the points, differentiable in the params (a graph
    is kept for a gradient of anything built from them)."""
    x, y, z = (t.detach().requires_grad_(True) for t in (x, y, z))
    psi = PSI[family](p, x, y, z, r)
    gx, gy, gz = torch.autograd.grad(psi.sum(), (x, y, z), create_graph=True)
    lap = (torch.autograd.grad(gx.sum(), x, create_graph=True)[0]
           + torch.autograd.grad(gy.sum(), y, create_graph=True)[0]
           + torch.autograd.grad(gz.sum(), z, create_graph=True)[0])
    return psi, lap


def potential(x, y, z, r):
    """V = -1/r1 - 1/r2."""
    r1, r2 = _radii(x, y, z, r)
    return -1.0 / r1 - 1.0 / r2
