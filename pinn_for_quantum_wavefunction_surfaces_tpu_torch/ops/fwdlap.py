"""Forward-Laplacian propagation: exact Laplacians in one forward pass.

The PyTorch counterpart of the JAX package's ``ops/fwdlap.py``. The triple

    (value v, spatial gradient g, laplacian l)

is carried through every layer in closed form (the "forward Laplacian"
scheme of Li et al., arXiv:2307.08214), so one pass gives psi, grad psi and
lap psi with no nested autograd.

Shapes (batch-first, d = feature width):
    v: (..., d)     values
    g: (..., 3, d)  d/dx, d/dy, d/dz stacked on axis -2
    l: (..., d)     laplacian

Rules:
    elementwise:  v' = f(v),     g' = f'(v) g,     l' = f'(v) l + f''(v) |g|^2
    product:      lap(ab) = a lap(b) + b lap(a) + 2 grad(a).grad(b)
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Spatial(NamedTuple):
    """A value together with its spatial gradient and laplacian."""

    v: torch.Tensor  # (..., d)
    g: torch.Tensor  # (..., 3, d)
    l: torch.Tensor  # (..., d)


def const(v: torch.Tensor) -> Spatial:
    """Lift a spatially-constant array (e.g. a function of R only)."""
    g = v.new_zeros(v.shape[:-1] + (3,) + v.shape[-1:])
    return Spatial(v, g, torch.zeros_like(v))


def _elementwise(s: Spatial, fv, d1, d2) -> Spatial:
    """Apply a scalar function given its value and first/second
    derivatives at s.v."""
    g = d1[..., None, :] * s.g
    gsq = torch.sum(s.g * s.g, dim=-2)
    return Spatial(fv, g, d1 * s.l + d2 * gsq)


def tanh(s: Spatial) -> Spatial:
    t = torch.tanh(s.v)
    d1 = 1.0 - t * t
    d2 = -2.0 * t * d1
    return _elementwise(s, t, d1, d2)


def exp(s: Spatial) -> Spatial:
    e = torch.exp(s.v)
    return _elementwise(s, e, e, e)


def add(a: Spatial, b: Spatial) -> Spatial:
    return Spatial(a.v + b.v, a.g + b.g, a.l + b.l)


def sub(a: Spatial, b: Spatial) -> Spatial:
    return Spatial(a.v - b.v, a.g - b.g, a.l - b.l)


def scale(s: Spatial, c) -> Spatial:
    """Multiply by a spatial constant (scalar or array broadcastable on v)."""
    if isinstance(c, torch.Tensor) and c.ndim:
        return Spatial(s.v * c, s.g * c[..., None, :], s.l * c)
    return Spatial(s.v * c, s.g * c, s.l * c)


def mul(a: Spatial, b: Spatial) -> Spatial:
    """Product rule, including the laplacian cross term."""
    v = a.v * b.v
    g = a.g * b.v[..., None, :] + b.g * a.v[..., None, :]
    cross = 2.0 * torch.sum(a.g * b.g, dim=-2)
    return Spatial(v, g, a.l * b.v + b.l * a.v + cross)


def gz_envelope(x, y, z, c1, c2, a, b) -> Spatial:
    """Guillemin-Zener two-centre envelope f = exp(-a r1 - b r2):

        grad f = -f (a u1 + b u2)            (u_i unit vectors from centres)
        lap  f =  f (a^2 + b^2 + 2 a b u1.u2 - 2a/r1 - 2b/r2)

    c1, c2: 3-tuples of centre coordinates; a, b per-point arrays."""
    d1 = (x - c1[0], y - c1[1], z - c1[2])
    d2 = (x - c2[0], y - c2[1], z - c2[2])
    r1 = torch.sqrt(d1[0] ** 2 + d1[1] ** 2 + d1[2] ** 2)
    r2 = torch.sqrt(d2[0] ** 2 + d2[1] ** 2 + d2[2] ** 2)
    f = torch.exp(-a * r1 - b * r2)
    inv1, inv2 = 1.0 / r1, 1.0 / r2
    u1 = torch.stack(d1, dim=-1) * inv1[..., None]
    u2 = torch.stack(d2, dim=-1) * inv2[..., None]
    a_ = a * torch.ones_like(r1)
    b_ = b * torch.ones_like(r1)
    g_vec = -(a_[..., None] * u1 + b_[..., None] * u2)
    u1u2 = torch.sum(u1 * u2, dim=-1)
    lap = f * (a_ ** 2 + b_ ** 2 + 2.0 * a_ * b_ * u1u2
               - 2.0 * a_ * inv1 - 2.0 * b_ * inv2)
    g = (f[..., None] * g_vec)[..., :, None]
    return Spatial(f[..., None], g, lap[..., None])


def radial_seed(x, y, z, cx, cy, cz) -> Spatial:
    """Distance r = |p - c| to a centre as a Spatial seed:
    grad r = u = (p - c)/r,   lap r = 2/r."""
    dx, dy, dz = x - cx, y - cy, z - cz
    r = torch.sqrt(dx * dx + dy * dy + dz * dz)
    inv_r = 1.0 / r
    u = torch.stack([dx, dy, dz], dim=-1) * inv_r[..., None]
    return Spatial(r[..., None], u[..., :, None], (2.0 * inv_r)[..., None])


# ---------------------------------------------------------------------------
# 1-D scalar-chain propagation: when a subnetwork's only spatial input is a
# single scalar s, carry the 1-D derivative triple (f, df/ds, d2f/ds2) and
# apply the spatial chain rule once at the end:
#     grad f = f'(s) grad s,    lap f = f'(s) lap s + f''(s) |grad s|^2.


class Scalar1D(NamedTuple):
    """A value with its first/second derivatives w.r.t. ONE scalar input."""

    v: torch.Tensor   # (..., d)
    d1: torch.Tensor  # (..., d)
    d2: torch.Tensor  # (..., d)


def seed1d(s: torch.Tensor, consts: list[torch.Tensor],
           w: torch.Tensor, b: torch.Tensor) -> Scalar1D:
    """First affine layer of a scalar-chain body: inputs [s, *consts] where
    only ``s`` varies in space (all shaped (..., 1))."""
    x = torch.cat([s] + list(consts), dim=-1)
    v = x @ w + b
    d1 = w[0].expand(v.shape)
    return Scalar1D(v, d1, torch.zeros_like(v))


def linear1d(t: Scalar1D, w: torch.Tensor, b: torch.Tensor | None = None) \
        -> Scalar1D:
    v = t.v @ w
    if b is not None:
        v = v + b
    return Scalar1D(v, t.d1 @ w, t.d2 @ w)


def tanh1d(t: Scalar1D) -> Scalar1D:
    """(tanh o f)'' = tanh''(f) f'^2 + tanh'(f) f''."""
    y = torch.tanh(t.v)
    g1 = 1.0 - y * y
    g2 = -2.0 * y * g1
    return Scalar1D(y, g1 * t.d1, g1 * t.d2 + g2 * t.d1 * t.d1)


def chain(t: Scalar1D, s: Spatial) -> Spatial:
    """Lift a scalar-chain triple f(s) onto s's spatial tuple. ``s`` has
    feature width 1; the result takes f's width."""
    g = t.d1[..., None, :] * s.g
    gsq = torch.sum(s.g * s.g, dim=-2)  # (..., 1)
    return Spatial(t.v, g, t.d1 * s.l + t.d2 * gsq)
