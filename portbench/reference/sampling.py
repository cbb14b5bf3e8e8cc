"""The batches of the three traffic kinds, derived again from the seed.

- ``dual_grid``: the polish's fixed training batch, per-R prolate-
  spheroidal Gauss grids of n_xi x n_eta and of coprime sizes, as separate
  R rows, the first padded with zero-weight points at (1, 1, 1);
- ``importance``: the Monte-Carlo trainer's draw, n_r half-distances and
  per R a mixture of the uniform box and Gamma(3) shells about the nuclei,
  with w = 1/q;
- ``collocation``: the residual trainer's uniform points in the box with
  R uniform, the nuclear clamp and the boundary masks.

The draws come from a ``torch.Generator`` on the device seeded as the run
seeds the program's, and take the same calls in the same order and type,
so the same seed gives the same points bit for bit: a frozen copy of the
sampling recipe, which the program's sampler must reproduce.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def spheroidal_grid(c: float, n_xi: int, n_eta: int, xi_span: float):
    """(x, rho, w) of the Gauss grid in prolate-spheroidal coordinates at
    focal half-distance c: xi in (1, 1 + xi_span / c), eta in (-1, 1), w
    the volume element 2 pi c^3 (xi^2 - eta^2) times the Gauss weights."""
    xi_nodes, xi_w = np.polynomial.legendre.leggauss(n_xi)
    eta_nodes, eta_w = np.polynomial.legendre.leggauss(n_eta)
    half = 0.5 * xi_span / c
    xi = 1.0 + half * (xi_nodes + 1.0)
    xi_g, eta_g = np.meshgrid(xi, eta_nodes, indexing="ij")
    w = np.outer(xi_w * half, eta_w) * (xi_g ** 2 - eta_g ** 2) \
        * (2.0 * np.pi * c ** 3)
    x = c * xi_g * eta_g
    rho = c * np.sqrt(np.maximum((xi_g ** 2 - 1.0) * (1.0 - eta_g ** 2), 0))
    return x.ravel(), rho.ravel(), w.ravel()


def _coprime(n: int, offset: int) -> int:
    m = n + offset
    while math.gcd(n, m) != 1:
        m += 1
    return m


def dual_grid_sizes(n_xi: int, n_eta: int) -> list[tuple[int, int]]:
    """(n_xi, n_eta) of the dual grid's two Gauss grids."""
    return [(n_xi, n_eta), (_coprime(n_xi, 17), _coprime(n_eta, 13))]


def dual_grid_points(n_r: int, n_xi: int, n_eta: int) -> int:
    """The dual grid's quadrature points, its padding left out."""
    return n_r * sum(nx * ne for nx, ne in dual_grid_sizes(n_xi, n_eta))


def dual_grid(dom: dict, n_r: int, n_xi: int, n_eta: int, dtype, device):
    """(x, y, z, w, r): rows (2 n_r, n_pts) and r (2 n_r,)."""
    r_values = np.linspace(dom["r_lo"], dom["r_hi"], n_r)
    sizes = dual_grid_sizes(n_xi, n_eta)
    n_pts = sizes[1][0] * sizes[1][1]
    cols = ([], [], [], [])
    for nx, ne in sizes:
        for c in r_values:
            x, rho, w = spheroidal_grid(float(c), nx, ne, dom["xi_span"])
            pad = (0, n_pts - x.size)
            for col, a, v in zip(cols, (x, rho, np.zeros_like(x), w),
                                 (1.0, 1.0, 1.0, 0.0)):
                col.append(np.pad(a, pad, constant_values=v))
    kw = dict(dtype=dtype, device=device)
    x, y, z, w = (torch.as_tensor(np.stack(c), **kw) for c in cols)
    return x, y, z, w, torch.as_tensor(
        np.concatenate([r_values, r_values]), **kw)


def _uniform(gen, shape, lo, hi, dtype):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return lo + (hi - lo) * u


def importance(gen, dom: dict, n_r: int, n_pts: int, dtype,
               antithetic: bool, stratified: bool):
    """(x, y, z, w, r) of one Monte-Carlo draw: rows (n_r, n_pts)."""
    dev = gen.device
    u = torch.rand(n_r, generator=gen, dtype=dtype, device=dev)
    if stratified:
        u = (torch.arange(n_r, dtype=dtype, device=dev) + u) / n_r
    r = dom["r_lo"] + (dom["r_hi"] - dom["r_lo"]) * u
    rows = r.reshape(-1, 1)
    scale = dom["focus_scale"] / (1.0 + 0.8 * torch.exp(-2.0 * rows))
    b = dom["box"]
    n_f = int(dom["focus_frac"] * n_pts)
    x, y, z = (_uniform(gen, (n_r, n_pts), -b, b, dtype) for _ in range(3))
    m = n_f // 2 if antithetic else n_f
    v = _uniform(gen, (n_r, m, 3), torch.finfo(torch.float64).tiny, 1.0,
                 torch.float64)
    if antithetic:
        n_f = 2 * m
        rad = torch.cat([-torch.log(v).sum(-1), -torch.log1p(-v).sum(-1)], 1)
    else:
        rad = -torch.log(v).sum(-1)
    rad = rad.to(dtype) * scale
    d = torch.randn((n_r, m, 3), generator=gen, dtype=dtype, device=dev)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    coin = torch.rand((n_r, m), generator=gen, dtype=dtype, device=dev)
    sign = torch.where(coin < 0.5, 1.0, -1.0).to(dtype)
    if antithetic:
        d, sign = torch.cat([d, d], 1), torch.cat([sign, sign], 1)
    x[:, :n_f] = sign * rows + rad * d[..., 0]
    y[:, :n_f] = sign * 0.0 + rad * d[..., 1]
    z[:, :n_f] = sign * 0.0 + rad * d[..., 2]
    # w = 1/q: q the box's uniform share plus the two shells' 3-D densities
    r1 = torch.sqrt((x - rows) ** 2 + y ** 2 + z ** 2)
    r2 = torch.sqrt((x + rows) ** 2 + y ** 2 + z ** 2)

    def shell(rr):
        pdf = torch.where(rr > 0, rr ** 2 * torch.exp(-rr / scale)
                          / (2.0 * scale ** 3), 0.0)
        return pdf / (4.0 * math.pi * rr ** 2)

    ff = dom["focus_frac"]
    in_box = ((x.abs() <= b) & (y.abs() <= b) & (z.abs() <= b)).to(dtype)
    q = (1.0 - ff) * in_box / (2.0 * b) ** 3 \
        + ff * 0.5 * (shell(r1) + shell(r2))
    return x, y, z, 1.0 / q, r


def collocation(gen, dom: dict, n: int, dtype):
    """(x, y, z, r, bc1, bc2) of one residual-trainer batch of n points."""
    b = dom["box"]
    x, y, z = (_uniform(gen, n, -b, b, dtype) for _ in range(3))
    r = _uniform(gen, n, dom["r_lo"], dom["r_hi"], dtype)

    def radii(x):
        return (torch.sqrt((x - r) ** 2 + y ** 2 + z ** 2),
                torch.sqrt((x + r) ** 2 + y ** 2 + z ** 2))

    r1, r2 = radii(x)
    cut = dom["cutoff"]
    x = torch.where((r1 < cut) | (r2 < cut), torch.full_like(x, cut), x)
    r1, r2 = radii(x)
    return x, y, z, r, r1 >= dom["bc_cutoff"], r2 >= dom["bc_cutoff"]
