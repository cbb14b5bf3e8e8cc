"""Eigenvalue-surface extraction: Rayleigh quotients on quadrature grids.

The PyTorch counterpart of the JAX package's ``analysis/energy.py``:

    E_int(R)  = <psi|H|psi> / <psi|psi>   on a quadrature grid
    E_net(R)  = the trainable eigenvalue head evaluated at R
    E_lcao(R) = the same quotient for the analytic LCAO ansatz (baseline)

on three grids: the uniform n^3 Simpson grid of the reference
(``rayleigh_quotient``), the nucleus-adapted Cartesian grid
(``rayleigh_quotient_adapted``) and the prolate-spheroidal Gauss grid
(``rayleigh_quotient_spheroidal``).

psi and lap psi come from ``psi_lap_forward``, keyed by the params as the
JAX package's ``ansatz.psi_fwdlap`` is, and forward only: separable params
go through K1 (``ops.pallas_separable``), reference-parity symmetric params
through K3 (``ops.pallas_residual``), symmetric params with alpha/GZ heads
through K2 (``ops.pallas_train``). On CUDA tensors every model quotient runs
through a Hopper kernel.

The Cartesian grids are evaluated in groups of whole x-slabs, up to
``CHUNK_POINTS`` points a launch (the 80^3 grid in one), and summed in the
JAX package's two levels: per slab over (y, z) with the weights w_y w_z,
then over x with w_x.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..models import ansatz
from ..ops import operators, quadrature
from ..ops.pallas_residual import is_reference_parity, psi_lap_pallas
from ..ops.pallas_separable import psi_lap_train_separable
from ..ops.pallas_train import psi_lap_train

# points a kernel launch of the Cartesian grids takes at most: whole
# x-slabs up to this count (80^3 = 512 000 in one launch; 250^3 in four)
CHUNK_POINTS = 1 << 22


def psi_lap_forward(params: dict, mcfg, x, y, z, r):
    """(psi, lap psi) of flat point arrays, forward only, through the kernel
    of the params' family: separable -> K1-fwd, reference-parity symmetric
    (no alpha/beta heads, 2-feature base) -> K3, symmetric with GZ or alpha
    -> K2-fwd. The minimal family, R-input models, node factors and m_abs
    raise NotImplementedError."""
    ansatz.check_supported(params, mcfg)
    with torch.no_grad():
        if "lam1" in params:
            return psi_lap_train_separable(params, mcfg, x, y, z, r)[:2]
        if is_reference_parity(params):
            return psi_lap_pallas(params, mcfg, x, y, z, r)
        return psi_lap_train(params, mcfg, x, y, z, r)[:2]


def lcao_fwdlap(mcfg, x, y, z, r):
    """psi and lap psi of the LCAO ansatz e^{-r1} + P e^{-r2} (analytic),
    for the baseline quotient."""

    def envelope(cx, cy, cz):
        dx, dy, dz = x - cx, y - cy, z - cz
        rr = torch.sqrt(dx * dx + dy * dy + dz * dz)
        f = torch.exp(-rr)
        return f, f * (1.0 - 2.0 * (1.0 / rr))

    f1, l1 = envelope(r, mcfg.ry, mcfg.rz)
    f2, l2 = envelope(-r, -mcfg.ry, -mcfg.rz)
    p = float(mcfg.inversion_symmetry)
    return f1 + f2 * p, l1 + l2 * p


def _psi_hpsi(params, cfg: Config, x, y, z, r, which: str):
    """psi and H psi of the model (``which="model"``) or of the LCAO
    baseline (``"lcao"``)."""
    if which == "lcao":
        psi, lap = lcao_fwdlap(cfg.model, x, y, z, r)
    elif which == "model":
        psi, lap = psi_lap_forward(params, cfg.model, x, y, z, r)
    else:
        raise ValueError(f"unknown quotient {which!r}: 'model' or 'lcao'")
    return psi, operators.hamiltonian_values(cfg.model, x, y, z, r, psi, lap)


def _like(params):
    ref = params["e1"]["w"]
    return dict(dtype=ref.dtype, device=ref.device)


def _rayleigh_grid(params, cfg: Config, ri: float, xg, wx, yg, wy, zg, wz,
                   which: str):
    """(num, den) sums of the quotient on explicit per-axis (nodes, weights)
    numpy arrays: per x-slab over (y, z), then over x."""
    kw = _like(params)
    xg, wx, yg, wy, zg, wz = (torch.as_tensor(np.asarray(a, np.float64),
                                              **kw)
                              for a in (xg, wx, yg, wy, zg, wz))
    yy, zz = torch.meshgrid(yg, zg, indexing="ij")
    yf, zf = yy.reshape(-1), zz.reshape(-1)
    wyz = (wy[:, None] * wz[None, :]).reshape(-1)
    per = yf.numel()
    step = max(1, CHUNK_POINTS // per)
    nums, dens = [], []
    with torch.no_grad():
        for i0 in range(0, xg.numel(), step):
            xs = xg[i0:i0 + step]
            k = xs.numel()
            x = xs.repeat_interleave(per)
            r = torch.full_like(x, float(ri))
            psi, hpsi = _psi_hpsi(params, cfg, x, yf.repeat(k), zf.repeat(k),
                                  r, which)
            psi, hpsi = psi.view(k, per), hpsi.view(k, per)
            nums.append(torch.sum(wyz * psi * hpsi, dim=1))
            dens.append(torch.sum(wyz * psi * psi, dim=1))
        return (torch.sum(wx * torch.cat(nums)),
                torch.sum(wx * torch.cat(dens)))


def rayleigh_quotient(params, cfg: Config, ri: float, n: Optional[int] = None,
                      scheme: str = "avg", which: str = "model") -> float:
    """E_int = <psi|H|psi>/<psi|psi> at half-distance ri on the uniform n^3
    Simpson grid over [-box, box]^3 (the reference's ``energy_from_psi``).
    Runs on the device and in the dtype of ``params``."""
    n = n or cfg.train.n_test
    box = cfg.domain.box
    ax = np.linspace(-box, box, n)
    w = quadrature.simpson_weights(n, 2.0 * box / (n - 1), scheme)
    num, den = _rayleigh_grid(params, cfg, ri, ax, w, ax, w, ax, w, which)
    return float(num / den)


def rayleigh_quotient_adapted(params, cfg: Config, ri: float,
                              n: Optional[int] = None,
                              which: str = "model",
                              strength: float = 0.45,
                              sharpness: float = 2.0) -> float:
    """E_int on a nucleus-adapted grid: x-axis nodes clustered at the two
    nuclei (+-R), y/z axes at the molecular plane
    (ops.quadrature.adapted_axis)."""
    n = n or cfg.train.n_test
    box = cfg.domain.box
    xg, wx = quadrature.adapted_axis(n, box, (-ri, ri), strength, sharpness)
    yg, wy = quadrature.adapted_axis(n, box, (0.0,), strength, sharpness)
    num, den = _rayleigh_grid(params, cfg, ri, xg, wx, yg, wy, yg, wy, which)
    return float(num / den)


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
                                 which: str = "model",
                                 xi_span: float | None = None) -> float:
    """E_int = <psi|H|psi>/<psi|psi> at half-distance ri on an n_xi x n_eta
    spheroidal Gauss grid (near machine precision for sigma states). Runs on
    the device and in the dtype of ``params``; ``which="lcao"`` scores the
    LCAO baseline instead of the model."""
    if cfg.model.ry or cfg.model.rz:
        raise NotImplementedError(
            "spheroidal quadrature assumes the nuclei on the x-axis")
    if xi_span is None:
        xi_span = cfg.domain.xi_span
    x, rho, w2d = spheroidal_grid(float(ri), n_xi, n_eta, xi_span)
    kw = _like(params)
    xf = torch.as_tensor(x, **kw)
    yf = torch.as_tensor(rho, **kw)
    zf = torch.zeros_like(yf)
    rf = torch.full_like(yf, float(ri))
    wf = torch.as_tensor(w2d, **kw)
    with torch.no_grad():
        psi, hpsi = _psi_hpsi(params, cfg, xf, yf, zf, rf, which)
        num = torch.sum(wf * psi * hpsi)
        den = torch.sum(wf * psi * psi)
    return float(num / den)


def energy_net(params, ri) -> float:
    """E_net: the eigenvalue head at R = ri."""
    with torch.no_grad():
        return float(ansatz.energy(params, torch.tensor([float(ri)],
                                                        **_like(params)))[0])


def surface(params, cfg: Config, r_values=None, n: int = 80,
            scheme: str = "avg", lcao: bool = True,
            grid: str = "uniform", progress=None) -> dict:
    """Sweep R and return the eigenvalue surface in the reference's artifact
    schema {R, E_int, Elcao, E_net} (the reference's ``calculate_E_R``).
    ``grid``: "uniform" (reference parity), "adapted" (nucleus-clustered
    nodes, doubled per axis below R = 1.6) or "spheroidal"."""
    dom = cfg.domain
    if r_values is None:
        r_values = np.round(np.arange(dom.r_lo, dom.r_hi + 0.1, 0.1), 2)
    r_values = np.asarray(r_values)
    e_int = np.zeros(len(r_values))
    e_net = np.zeros(len(r_values))
    e_lcao = np.zeros(len(r_values))

    def quotient(ri, which):
        if grid == "spheroidal":
            return rayleigh_quotient_spheroidal(params, cfg, float(ri),
                                                which=which)
        if grid == "adapted":
            # the united-atom orbital tightens at small R: double the axis
            # resolution there
            n_eff = n * 2 if ri < 1.6 else n
            return rayleigh_quotient_adapted(params, cfg, float(ri), n=n_eff,
                                             which=which)
        if grid != "uniform":
            raise ValueError(f"unknown grid {grid!r}")
        return rayleigh_quotient(params, cfg, float(ri), n=n, scheme=scheme,
                                 which=which)

    for i, ri in enumerate(r_values):
        e_int[i] = quotient(ri, "model")
        if lcao:
            e_lcao[i] = quotient(ri, "lcao")
        e_net[i] = energy_net(params, float(ri))
        if progress is not None:
            progress(i, len(r_values), ri)
    return {"R": r_values, "E_int": e_int, "Elcao": e_lcao, "E_net": e_net}


def save_surface(path: str, surf: dict) -> None:
    """Persist in the reference's pickle schema {R, E_int, Elcao, E_net}."""
    with open(path, "wb") as f:
        pickle.dump(surf, f)


def load_surface(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


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
