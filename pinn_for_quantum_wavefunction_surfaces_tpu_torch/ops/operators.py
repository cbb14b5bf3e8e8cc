"""Physics of the two-centre problem: radii, Coulomb potential, H psi and
the PDE residual.

The PyTorch counterpart of the physics functions and residual conventions
of the JAX package's ``ops/operators.py``.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig


def radial(mcfg: ModelConfig, x, y, z, r):
    """Distances to the two nuclei at (+/-R, +/-ry, +/-rz)."""
    r1 = torch.sqrt((x - r) ** 2 + (y - mcfg.ry) ** 2 + (z - mcfg.rz) ** 2)
    r2 = torch.sqrt((x + r) ** 2 + (y + mcfg.ry) ** 2 + (z + mcfg.rz) ** 2)
    return r1, r2


def potential(mcfg: ModelConfig, x, y, z, r):
    """Two-centre Coulomb attraction V = -1/r1 - 1/r2."""
    r1, r2 = radial(mcfg, x, y, z, r)
    return -1.0 / r1 - 1.0 / r2


def hamiltonian_values(mcfg: ModelConfig, x, y, z, r, psi_v, lap_v):
    """H psi = -1/2 lap psi + V psi, given psi and lap psi."""
    return -0.5 * lap_v + potential(mcfg, x, y, z, r) * psi_v


def residual_poc(mcfg: ModelConfig, x, y, z, r, psi_v, lap_v, e_v):
    """Canonical residual (H - E) psi in Hartree atomic units."""
    return hamiltonian_values(mcfg, x, y, z, r, psi_v, lap_v) - e_v * psi_v


def residual_minimal(mcfg: ModelConfig, x, y, z, r, psi_v, lap_v, e_v):
    """The minimal trainer's residual lap psi + (e + 1/r1 + 1/r2) psi (no
    1/2 on the laplacian, no 2 on the potential: its ``e`` is not the
    Hartree electronic energy)."""
    r1, r2 = radial(mcfg, x, y, z, r)
    return lap_v + (e_v + 1.0 / r1 + 1.0 / r2) * psi_v


RESIDUALS = {"poc": residual_poc, "minimal": residual_minimal}
