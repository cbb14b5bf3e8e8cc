"""Tabulated, cubic-spline E(R) export: the surface without the E head's fit
floor.

The PyTorch counterpart of the JAX package's ``analysis/etab.py``: dense
per-R prolate-spheroidal Rayleigh quotients E*(R) of the trained psi at
``n_knots`` knots, interpolated with a not-a-knot cubic spline. The table
rides in the native ``.npz`` checkpoint as an ``e_table`` subtree (knots and
values; the spline coefficients are rebuilt on load). Only ``build_table``
touches the model; the spline functions are numpy, copied from the JAX
package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import Config


def cubic_spline_coeffs(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Second derivatives M_i of the not-a-knot cubic spline through (x, y):
    the tridiagonal continuity system with not-a-knot end rows (the end
    condition of scipy.interpolate.CubicSpline's default)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = len(x)
    if n < 4:
        raise ValueError("not-a-knot spline needs >= 4 knots")
    h = np.diff(x)
    # rows 1..n-2: h[i-1] M[i-1] + 2(h[i-1]+h[i]) M[i] + h[i] M[i+1]
    #            = 6 ((y[i+1]-y[i])/h[i] - (y[i]-y[i-1])/h[i-1])
    a = np.zeros((n, n))
    b = np.zeros(n)
    for i in range(1, n - 1):
        a[i, i - 1] = h[i - 1]
        a[i, i] = 2.0 * (h[i - 1] + h[i])
        a[i, i + 1] = h[i]
        b[i] = 6.0 * ((y[i + 1] - y[i]) / h[i] - (y[i] - y[i - 1]) / h[i - 1])
    # not-a-knot: M continuous in the 3rd derivative at x[1] and x[n-2]
    a[0, 0] = h[1]
    a[0, 1] = -(h[0] + h[1])
    a[0, 2] = h[0]
    a[-1, -3] = h[-1]
    a[-1, -2] = -(h[-2] + h[-1])
    a[-1, -1] = h[-2]
    return np.linalg.solve(a, b)


def spline_eval(x: np.ndarray, y: np.ndarray, m: np.ndarray,
                r) -> np.ndarray:
    """The cubic spline (knots x, values y, 2nd derivatives m) at r.
    Outside [x[0], x[-1]] the end cubic extrapolates (as scipy's does)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    r = np.atleast_1d(np.asarray(r, np.float64))
    i = np.clip(np.searchsorted(x, r) - 1, 0, len(x) - 2)
    h = x[i + 1] - x[i]
    t = r - x[i]
    u = x[i + 1] - r
    out = (m[i] * u ** 3 + m[i + 1] * t ** 3) / (6.0 * h) \
        + (y[i] / h - m[i] * h / 6.0) * u \
        + (y[i + 1] / h - m[i + 1] * h / 6.0) * t
    return out


def build_table(params: dict, cfg: Config, n_knots: int = 153,
                r_values=None, n_xi: int = 96, n_eta: int = 96,
                progress=None) -> dict:
    """Dense per-R spheroidal Rayleigh-quotient table of the trained psi
    (port params), one quotient a knot. The default knots are uniform in
    log(R + 0.3) over [r_lo, r_hi]: the surface's curvature grows toward the
    united-atom end. Returns {"R": knots, "E": values} (float64 numpy)."""
    from . import energy as aen

    dom = cfg.domain
    if r_values is None:
        t = np.linspace(np.log(dom.r_lo + 0.3), np.log(dom.r_hi + 0.3),
                        n_knots)
        r_values = np.exp(t) - 0.3
        r_values[0], r_values[-1] = dom.r_lo, dom.r_hi
    r_values = np.asarray(r_values, np.float64)
    e = np.zeros(len(r_values))
    for i, ri in enumerate(r_values):
        e[i] = aen.rayleigh_quotient_spheroidal(params, cfg, float(ri),
                                                n_xi=n_xi, n_eta=n_eta)
        if progress is not None:
            progress(i, len(r_values), ri)
    return {"R": r_values, "E": e}


def energy_from_table(table: dict, r) -> np.ndarray:
    """E(R) from an exported table (spline coefficients rebuilt on the fly)."""
    x = np.asarray(table["R"], np.float64)
    y = np.asarray(table["E"], np.float64)
    return spline_eval(x, y, cubic_spline_coeffs(x, y), r)


def spline_eval_deriv(x: np.ndarray, y: np.ndarray, m: np.ndarray,
                      r) -> np.ndarray:
    """d/dr of the cubic spline, in closed form."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    r = np.atleast_1d(np.asarray(r, np.float64))
    i = np.clip(np.searchsorted(x, r) - 1, 0, len(x) - 2)
    h = x[i + 1] - x[i]
    t = r - x[i]
    u = x[i + 1] - r
    return (-m[i] * u ** 2 + m[i + 1] * t ** 2) / (2.0 * h) \
        - (y[i] / h - m[i] * h / 6.0) + (y[i + 1] / h - m[i + 1] * h / 6.0)


def force_from_table(table: dict, r) -> np.ndarray:
    """F = -dE_total/dR from the exported table, with the nuclear repulsion
    1/(2R) of the half distance R: F = -E_el'(R) + 1/(2R^2)."""
    x = np.asarray(table["R"], np.float64)
    y = np.asarray(table["E"], np.float64)
    r = np.atleast_1d(np.asarray(r, np.float64))
    de = spline_eval_deriv(x, y, cubic_spline_coeffs(x, y), r)
    return -de + 0.5 / r ** 2


def load_table(path: str) -> Optional[dict]:
    """The ``e_table`` subtree of a native checkpoint, or None if absent."""
    from ..io import checkpoint

    tree, _ = checkpoint.load_params(path)
    t = tree.get("e_table")
    if t is None:
        return None
    return {"R": np.asarray(t["R"], np.float64),
            "E": np.asarray(t["E"], np.float64)}
