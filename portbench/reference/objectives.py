"""The two objectives and optax's Adam, in plain PyTorch.

- ``quotient``: the mean over R rows of the Rayleigh quotients E_r =
  sum(w psi H psi) / sum(w psi^2), H psi = -lap psi / 2 + V psi, plus the
  E head's fit head_weight * mean((E(R) - E_r)^2), E_r held fixed there;
- ``residual``: mean(((H - E(R)) psi)^2) over the points plus the boundary
  decay mean(psi^2 | r1 >= cutoff) + mean(psi^2 | r2 >= cutoff);
- ``adam``: optax.adam's update, p - lr m_hat / (sqrt(v_hat) + eps).

Each returns the loss and its gradient in every leaf; the quotient runs in
blocks of rows so that a million points fit beside what is left on the
card. ``keep`` < 1 keeps only that share of the batch, the first points of
each row, and takes the means over them: a fault the comparison has to
catch. (Leaving out rows would not do for the polish: its two grids give
the same quotients to rounding.)
"""

from __future__ import annotations

import torch

from .ansatz import energy, potential, psi_lap


def _leaves(p):
    return [p[k][f] for k in sorted(p) for f in sorted(p[k])]


def _grads(loss, p):
    gs = torch.autograd.grad(loss, _leaves(p), allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(_leaves(p), gs)]


BLOCK_POINTS = 1 << 18


def quotient(family, p, batch, head_weight=1.0, keep=1.0):
    """(loss, [grad of each leaf]) of the quotient objective on ``batch``
    = (x, y, z, w, r), rows (n_r, n_pts), r (n_r,)."""
    x, y, z, w, r = batch
    n_pts = max(1, int(x.shape[1] * keep))
    x, y, z, w = x[:, :n_pts], y[:, :n_pts], z[:, :n_pts], w[:, :n_pts]
    n_r = x.shape[0]
    step = max(1, BLOCK_POINTS // n_pts)
    grads = [torch.zeros_like(t) for t in _leaves(p)]
    e_r = []
    for i in range(0, n_r, step):
        sl = slice(i, min(i + step, n_r))
        rr = r[sl, None].expand(-1, n_pts)
        psi, lap = psi_lap(family, p, x[sl], y[sl], z[sl], rr)
        hpsi = -0.5 * lap + potential(x[sl], y[sl], z[sl], rr) * psi
        e = torch.sum(w[sl] * psi * hpsi, 1) / torch.sum(w[sl] * psi * psi, 1)
        for acc, g in zip(grads, _grads(e.sum() / n_r, p)):
            acc += g
        e_r.append(e.detach())
    e_r = torch.cat(e_r)
    l_head = torch.mean((energy(p, r) - e_r) ** 2)
    for acc, g in zip(grads, _grads(head_weight * l_head, p)):
        acc += g
    return float(e_r.mean() + head_weight * l_head.detach()), grads


def residual(family, p, batch, keep=1.0):
    """(loss, [grad of each leaf]) of the residual objective on ``batch``
    = (x, y, z, r, bc1, bc2), each (n,)."""
    n = max(1, int(batch[0].shape[0] * keep))
    x, y, z, r, bc1, bc2 = (t[:n] for t in batch)
    psi, lap = psi_lap(family, p, x, y, z, r)
    res = -0.5 * lap + potential(x, y, z, r) * psi - energy(p, r) * psi
    psi2 = psi * psi

    def bc(mask):
        return torch.sum(torch.where(mask, psi2, 0.0)) / \
            torch.clamp(torch.sum(mask), min=1)

    loss = torch.mean(res * res) + bc(bc1) + bc(bc2)
    return float(loss.detach()), _grads(loss, p)


class Adam:
    """optax.adam on a list of leaves, in their type."""

    def __init__(self, leaves, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(t) for t in leaves]
        self.nu = [torch.zeros_like(t) for t in leaves]
        self.count = 0

    @torch.no_grad()
    def step(self, leaves, grads, lr):
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for t, g, mu, nu in zip(leaves, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            t.sub_(lr * (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps))
