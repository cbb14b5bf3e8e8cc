"""Eigenvalue scoring: Rayleigh quotients on prolate-spheroidal Gauss grids.

The PyTorch counterpart of ``spheroidal_grid``,
``rayleigh_quotient_spheroidal`` and the exact-energy rulers of the JAX
package's ``analysis/energy.py``. psi and lap psi come from the fused kernel
of the params' family (forward only): separable params go through K1
(``ops.pallas_separable``), symmetric ones through K2 (``ops.pallas_train``),
so on a CUDA tensor the scoring runs through a Hopper kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..ops import operators
from ..ops.pallas_separable import psi_lap_train_separable
from ..ops.pallas_train import psi_lap_train


def spheroidal_grid(c: float, n_xi: int, n_eta: int,
                    xi_span: float = 20.0):
    """Flattened prolate-spheroidal Gauss grid for focal half-distance c:
    returns (x, rho, w) 1-D numpy arrays such that for any axially-symmetric
    f, sum(w * f(x, rho, 0)) integrates f over R^3.

    xi maps from (-1, 1) to (1, 1 + xi_span/c), covering r1+r2 up to
    2c + 2*xi_span. The single source of the training-objective and
    evaluation grids (training/variational.spheroidal_vbatch uses it)."""
    xi_nodes, xi_w = np.polynomial.legendre.leggauss(n_xi)
    eta_nodes, eta_w = np.polynomial.legendre.leggauss(n_eta)
    half = 0.5 * xi_span / c
    xi = 1.0 + half * (xi_nodes + 1.0)
    wxi = xi_w * half
    xi_g, eta_g = np.meshgrid(xi, eta_nodes, indexing="ij")
    w2d = np.outer(wxi, eta_w) * (xi_g ** 2 - eta_g ** 2) \
        * (2.0 * np.pi * c ** 3)
    x = c * xi_g * eta_g
    rho = c * np.sqrt(np.maximum((xi_g ** 2 - 1.0) * (1.0 - eta_g ** 2),
                                 0.0))
    return x.ravel(), rho.ravel(), w2d.ravel()


def rayleigh_quotient_spheroidal(params, cfg: Config, ri: float,
                                 n_xi: int = 96, n_eta: int = 96,
                                 xi_span: float | None = None) -> float:
    """E_int = <psi|H|psi>/<psi|psi> at half-distance ri on an n_xi x n_eta
    spheroidal Gauss grid (near machine precision for sigma states). Runs on
    the device and in the dtype of ``params`` (port params); the family is
    read off the params, as the JAX function's forward dispatches."""
    if cfg.model.ry or cfg.model.rz:
        raise NotImplementedError(
            "spheroidal quadrature assumes the nuclei on the x-axis")
    ref = params["e1"]["w"]
    if xi_span is None:
        xi_span = cfg.domain.xi_span
    x, rho, w2d = spheroidal_grid(float(ri), n_xi, n_eta, xi_span)
    kw = dict(dtype=ref.dtype, device=ref.device)
    xf = torch.as_tensor(x, **kw)
    yf = torch.as_tensor(rho, **kw)
    zf = torch.zeros_like(yf)
    rf = torch.full_like(yf, float(ri))
    wf = torch.as_tensor(w2d, **kw)
    with torch.no_grad():
        fused = (psi_lap_train_separable if "lam1" in params
                 else psi_lap_train)
        psi, lap, _ = fused(params, cfg.model, xf, yf, zf, rf)
        hpsi = operators.hamiltonian_values(cfg.model, xf, yf, zf, rf, psi,
                                            lap)
        num = torch.sum(wf * psi * hpsi)
        den = torch.sum(wf * psi * psi)
    return float(num / den)


# Exact H2+ energies: H. Wind, J. Chem. Phys. 42, 2371 (1965). R is the HALF
# internuclear distance, step 0.1 from 0.2 to 4.0; energies are electronic.
WIND_R = np.round(np.arange(0.2, 4.1, 0.1), 2)
WIND_E = np.array([
    -1.8008, -1.6715, -1.5545, -1.4518, -1.3623, -1.2843, -1.2159, -1.1558,
    -1.1026, -1.0554, -1.0132, -0.9754, -0.9415, -0.9109, -0.8832, -0.8582,
    -0.8355, -0.8149, -0.7961, -0.7790, -0.7634, -0.7492, -0.7363, -0.7244,
    -0.7136, -0.7037, -0.6946, -0.6863, -0.6786, -0.6716, -0.6651, -0.6591,
    -0.6536, -0.6485, -0.6437, -0.6392, -0.6351, -0.6312, -0.6276,
])


def exact_energy(r_values, oracle: str = "wind") -> np.ndarray:
    """Exact electronic E(R): ``"wind"`` interpolates the 4-decimal Wind
    table; ``"ode"`` solves the separated problem to ~1e-11 Ha
    (analysis/exact.py), seeded by the Wind interpolant."""
    r = np.asarray(r_values, np.float64)
    wind = np.interp(r, WIND_R, WIND_E)
    if oracle == "wind":
        return wind
    if oracle != "ode":
        raise ValueError(f"unknown oracle {oracle!r}")
    from .exact import exact_surface
    in_table = (r >= WIND_R[0]) & (r <= WIND_R[-1])
    return exact_surface(r, "1ssg",
                         guesses=np.where(in_table, wind, np.nan))


def exact_energy_ode(r_values, state: str = "1ssg") -> np.ndarray:
    """Sub-microhartree exact E_el(R) of ``state`` (analysis/exact.py)."""
    from .exact import exact_surface
    r = np.asarray(r_values, np.float64)
    if state == "1ssg":
        return exact_energy(r, oracle="ode")
    return exact_surface(r, state)
