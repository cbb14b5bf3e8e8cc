"""Simpson quadrature on separable 3-D grids.

The PyTorch counterpart of the JAX package's ``ops/quadrature.py``. The
nodes and weights are built in numpy, as there, so both packages integrate
on identical grids; only the contractions run in torch. For a separable
grid the triple Simpson integral is

    I = sum_ijk  w_i w_j w_k  f_ijk  =  w . ((f @ w) @ w)

Two even-sample schemes: ``avg`` (scipy <= 1.10 ``simps``'s default, the
scheme of the reference artifacts) and ``cartwright`` (scipy >= 1.11).
"""

from __future__ import annotations

import numpy as np
import torch


def simpson_weights(n: int, dx: float, scheme: str = "avg") -> np.ndarray:
    """Quadrature weights w such that sum(w * f) approximates the integral of
    f sampled on n uniformly spaced points with spacing dx.

    Odd n: composite Simpson [1,4,2,...,2,4,1] * dx/3.
    Even n:
      - "avg": the average of {Simpson on the first n-1 points + trapezoid
        on the last interval} and {trapezoid on the first interval +
        Simpson on the last n-1 points};
      - "cartwright": Simpson on the first n-1 points plus the correction
        h/12 * [-1, 8, 5] on the last three.
    """
    if n < 2:
        raise ValueError("need at least 2 samples")
    if n == 2:
        return np.array([0.5, 0.5]) * dx

    def simpson_odd(m: int) -> np.ndarray:
        w = np.ones(m)
        w[1:-1:2] = 4.0
        w[2:-1:2] = 2.0
        return w * (dx / 3.0)

    if n % 2 == 1:
        return simpson_odd(n)
    if scheme == "avg":
        wa = np.zeros(n)
        wa[: n - 1] += simpson_odd(n - 1)       # Simpson on first n-1
        wa[-2:] += 0.5 * dx                      # trapezoid on last interval
        wb = np.zeros(n)
        wb[1:] += simpson_odd(n - 1)             # Simpson on last n-1
        wb[:2] += 0.5 * dx                       # trapezoid on first interval
        return 0.5 * (wa + wb)
    if scheme == "cartwright":
        w = np.zeros(n)
        w[: n - 1] += simpson_odd(n - 1)
        w[-3:] += np.array([-1.0, 8.0, 5.0]) * (dx / 12.0)
        return w
    raise ValueError(f"unknown even-sample scheme {scheme!r}")


def adapted_axis(n: int, box: float, centers, strength: float = 0.45,
                 sharpness: float = 2.0) -> tuple[np.ndarray, np.ndarray]:
    """Nucleus-adapted quadrature axis: nodes clustered around ``centers``.

    Substituting x = g(u) = u - A * sum_c tanh(s (u - c)) with
    A s len(centers) < 1/2 keeps g monotone while shrinking dx/du near each
    centre, where the cusp of the integrand lives. Nodes are g(u_k) on a
    uniform u-grid and weights are the Simpson u-weights times g'(u_k).

    Returns (nodes, weights) with nodes spanning ~[-box, box].
    """
    centers = np.atleast_1d(np.asarray(centers, np.float64))
    a = strength / (sharpness * max(len(centers), 1))

    def g(u):
        return u - a * sum(np.tanh(sharpness * (u - c)) for c in centers)

    def gp(u):
        return 1.0 - a * sharpness * sum(
            1.0 / np.cosh(sharpness * (u - c)) ** 2 for c in centers)

    # choose U so that g(U) == box (g is monotone; bisect)
    lo, hi = box, box + 2 * a * len(centers) + 1.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if g(mid) < box:
            lo = mid
        else:
            hi = mid
    big_u = 0.5 * (lo + hi)
    u = np.linspace(-big_u, big_u, n)
    du = u[1] - u[0]
    w_u = simpson_weights(n, du)
    return g(u), w_u * gp(u)


def integrate_1d(f: torch.Tensor, w) -> torch.Tensor:
    return f @ torch.as_tensor(w, dtype=f.dtype, device=f.device)


def integrate_3d(f: torch.Tensor, wx, wy, wz) -> torch.Tensor:
    """sum_ijk wx_i wy_j wz_k f_ijk via three contractions."""
    kw = dict(dtype=f.dtype, device=f.device)
    return torch.einsum("i,j,k,ijk->", torch.as_tensor(wx, **kw),
                        torch.as_tensor(wy, **kw), torch.as_tensor(wz, **kw),
                        f)
