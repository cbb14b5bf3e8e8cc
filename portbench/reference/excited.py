"""Plain PyTorch reference of the excited separable family and of its
penalty-deflated quotient objective.

Written from the equations (arXiv:2211.04607's separable-spheroidal ansatz,
the package's description of its excited-state factors, and its
deflation), with nuclei at (+/-R, 0, 0) and Phi_GZ in the gerade sector:

    psi = Phi_GZ exp(3 tanh((l(t, R/4) + m(eta^2, R/4)) / 3))
          [(r1 + r2)/2 - R xi0(R)]      a radial node  ("rnode*" params)
          [eta^2 - eta0^2(R)]           an angular node ("enode*" params)
          Re[(y + i z)^m]               the |m| = m transverse factor

- Phi_GZ = e^{-a r1 - b r2} + e^{-a r2 - b r1}, t = e^{R - (r1 + r2)/2},
  eta^2 = ((r1 - r2) / 2R)^2, l and m tanh MLPs 2 -> H -> H -> 1;
- a(R) = 1.275 + 0.975 tanh(head) (the wide range, "xalpha*" params),
  b(R) = 0.75 (1 + tanh(head)), xi0(R) = 1 + (12 / R) sigmoid(head),
  eta0^2(R) = sigmoid(head), each head a sigmoid MLP 1 -> Ha -> 1;
- lap psi by autograd (three second derivatives), sharing no arithmetic
  with the program's forward-Laplacian pass.

The objective (``quotient_deflated``) targets the lowest state of the
sector orthogonal to k frozen references phi_i, evaluated by the same
equations under the target's m: per R row, with the quadrature weights w,

    q_r    = sum(w psi H psi) / sum(w psi^2),  H psi = -lap psi / 2 + V psi
    phi_i  Gram-Schmidt orthogonalised in order, in sum(w . .)
    o_i    = sum(w psi phi_i),  n0_i = sum(w phi_i^2)
    loss   = mean q_r + head_weight mean((E(R) - q_r)^2)
             + 4 mean(sum_i o_i^2 / (n0_i sum(w psi^2)))

with q_r held fixed in the head term, the rows in blocks as
``objectives.quotient`` takes them.

Departures from the published recipe: the references are the shipped
checkpoints, not states polished in the same run; the transverse factor,
the node factors and the deflation penalty are the package's additions to
the paper's ground-state ansatz. A factor's presence is read from the
params (a checkpoint describes itself); m is the target's.
"""

from __future__ import annotations

import torch

from .ansatz import LOG_CORR_CAP, _head, _radii, energy, potential
from .objectives import BLOCK_POINTS, _grads, _leaves

XALPHA_MID, XALPHA_HALF = 1.275, 0.975
RNODE_CAP = 12.0
OVERLAP_PENALTY = 4.0


def transverse(y, z, m: int):
    """Re[(y + i z)^m]: y for m = 1, y^2 - z^2 for m = 2; 1 for m = 0."""
    re, im = torch.ones_like(y), torch.zeros_like(y)
    for _ in range(m):
        re, im = re * y - im * z, re * z + im * y
    return re


def psi_excited(p, x, y, z, r, m: int):
    r1, r2 = _radii(x, y, z, r)
    a = XALPHA_MID + XALPHA_HALF * torch.tanh(_head(p, "xalpha", r))
    b = 0.75 * (1.0 + torch.tanh(_head(p, "beta", r)))
    phi = torch.exp(-a * r1 - b * r2) + torch.exp(-a * r2 - b * r1)
    half = 0.5 * (r1 + r2)
    t = torch.exp(r - half)
    eta2 = (0.5 * (r1 - r2) / r) ** 2
    rf = 0.25 * r

    def mlp(s, k):
        h = torch.tanh(torch.stack([s, rf], -1) @ p[k + "1"]["w"]
                       + p[k + "1"]["b"])
        h = torch.tanh(h @ p[k + "2"]["w"] + p[k + "2"]["b"])
        return (h @ p[k + "out"]["w"] + p[k + "out"]["b"])[..., 0]

    c = LOG_CORR_CAP
    out = phi * torch.exp(c * torch.tanh((mlp(t, "lam") + mlp(eta2, "mu"))
                                         / c))
    if "rnode1" in p:
        xi0 = 1.0 + (RNODE_CAP / r) * torch.sigmoid(_head(p, "rnode", r))
        out = out * (half - r * xi0)
    if "enode1" in p:
        out = out * (eta2 - torch.sigmoid(_head(p, "enode", r)))
    return out * transverse(y, z, m)


def psi_lap(p, x, y, z, r, m: int):
    """(psi, lap psi) at the points, differentiable in the params."""
    x, y, z = (t.detach().requires_grad_(True) for t in (x, y, z))
    psi = psi_excited(p, x, y, z, r, m)
    gx, gy, gz = torch.autograd.grad(psi.sum(), (x, y, z), create_graph=True)
    lap = (torch.autograd.grad(gx.sum(), x, create_graph=True)[0]
           + torch.autograd.grad(gy.sum(), y, create_graph=True)[0]
           + torch.autograd.grad(gz.sum(), z, create_graph=True)[0])
    return psi, lap


@torch.no_grad()
def reference_rows(refs, x, y, z, w, r, m: int):
    """(k, n_r, n_pts) values of the references on the rows, Gram-Schmidt
    orthogonalised row by row in the quadrature inner product."""
    rr = r[:, None].expand_as(x)
    rows = []
    for q in refs:
        v = psi_excited(q, x, y, z, rr, m)
        for u in rows:
            v = v - (torch.sum(w * v * u, 1) / torch.sum(w * u * u, 1))[
                :, None] * u
        rows.append(v)
    return torch.stack(rows)


def quotient_deflated(p, batch, refs, m: int, head_weight=1.0, keep=1.0):
    """(loss, [grad of each leaf]) of the deflated quotient objective on
    ``batch`` = (x, y, z, w, r), rows (n_r, n_pts), r (n_r,), against the
    reference params ``refs`` (in order). ``keep`` as in
    ``objectives.quotient``: the first share of each row's points."""
    x, y, z, w, r = batch
    n_pts = max(1, int(x.shape[1] * keep))
    x, y, z, w = x[:, :n_pts], y[:, :n_pts], z[:, :n_pts], w[:, :n_pts]
    n_r = x.shape[0]
    phi = reference_rows(refs, x, y, z, w, r, m)
    n0 = torch.sum(w * phi * phi, 2)                   # (k, n_r)
    step = max(1, BLOCK_POINTS // n_pts)
    grads = [torch.zeros_like(t) for t in _leaves(p)]
    q_r, contam = [], []
    for i in range(0, n_r, step):
        sl = slice(i, min(i + step, n_r))
        rr = r[sl, None].expand(-1, n_pts)
        psi, lap = psi_lap(p, x[sl], y[sl], z[sl], rr, m)
        hpsi = -0.5 * lap + potential(x[sl], y[sl], z[sl], rr) * psi
        n_ = torch.sum(w[sl] * psi * psi, 1)
        q = torch.sum(w[sl] * psi * hpsi, 1) / n_
        o = torch.sum(w[sl] * psi * phi[:, sl], 2)     # (k, rows)
        c = torch.sum(o * o / n0[:, sl], 0) / n_
        for acc, g in zip(grads, _grads((q.sum() + OVERLAP_PENALTY
                                         * c.sum()) / n_r, p)):
            acc += g
        q_r.append(q.detach())
        contam.append(c.detach())
    q_r, contam = torch.cat(q_r), torch.cat(contam)
    l_head = torch.mean((energy(p, r) - q_r) ** 2)
    for acc, g in zip(grads, _grads(head_weight * l_head, p)):
        acc += g
    loss = q_r.mean() + head_weight * l_head.detach() \
        + OVERLAP_PENALTY * contam.mean()
    return float(loss), grads
