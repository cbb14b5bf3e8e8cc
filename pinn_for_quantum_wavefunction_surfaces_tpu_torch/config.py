"""Typed, immutable configuration of the PyTorch port.

A copy of the fields of ``pinn_for_quantum_wavefunction_surfaces_tpu.config``
that the separable-spheroidal variational path reads, with the same defaults
and the same validation. The port keeps its own copy: it imports nothing of
the JAX package.

Conventions (as in the JAX package):
- ``R`` is the *half* internuclear distance; the nuclei sit at
  ``(+/-R, +/-ry, +/-rz)``. Total energy = E_electronic + 1/(2R).
- All lengths in Bohr, energies in Hartree.

There is no kernel switch: a CUDA tensor goes through the Hopper kernels, a
CPU tensor through their plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the parametric ansatz psi(x, y, z; R).

    Only ``arch="separable"`` runs in this port so far: psi = Phi_GZ(x; R) *
    exp(l(xi; R) + m(eta^2; R)), two width-``hidden`` tanh MLPs in
    prolate-spheroidal features. The node factors (xi_node, xi_node2,
    eta_node) and the transverse factor (m_abs) are validated here but
    raise NotImplementedError in the ansatz.
    """

    arch: str = "symmetric"
    hidden: int = 16         # correction-MLP width
    hidden_e: int = 32       # eigenvalue-head width
    inversion_symmetry: int = 1  # P = +1 gerade (1s sigma_g), -1 ungerade
    ry: float = 0.0          # nuclei offset in y
    rz: float = 0.0          # nuclei offset in z
    eout_bias_init: float = -1.0
    hidden_alpha: int = 8    # width of the alpha(R) and b(R) heads
    xi_node: bool = False
    xi_node2: bool = False
    eta_node: bool = False
    m_abs: int = 0
    # alpha(R) in (0.3, 2.25) (params key "xalpha*") instead of (0.75, 2.25)
    wide_alpha: bool = False

    def __post_init__(self):
        if self.arch not in ("symmetric", "minimal", "separable"):
            raise ValueError(f"unknown arch {self.arch!r}")
        if self.inversion_symmetry not in (-1, 1):
            raise ValueError("inversion_symmetry must be +1 or -1")
        if self.m_abs < 0:
            raise ValueError("m_abs must be >= 0")
        if self.m_abs and self.arch != "separable":
            raise ValueError("m_abs > 0 (pi/delta sectors) requires the "
                             "separable arch")
        if self.wide_alpha and self.arch != "separable":
            raise ValueError("wide_alpha requires the separable arch")


@dataclasses.dataclass(frozen=True)
class DomainConfig:
    """Quadrature domain of the deterministic variational objective."""

    r_lo: float = 0.2        # half-distance range lower bound
    r_hi: float = 4.0        # upper bound
    # prolate-spheroidal quadrature extent (absolute, bohr): xi covers
    # r1 + r2 up to 2R + 2 * xi_span
    xi_span: float = 20.0
    # R-row layout: "uniform" = linspace(r_lo, r_hi, n_r); "log" clusters
    # rows in log(R + 0.3) toward the united-atom end
    r_cluster: str = "uniform"
    fixed_r: Optional[float] = None  # train at one R


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training fields the variational polish reads."""

    seed: int = 12345        # parameter init


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level config: model + domain + training + numerics."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    domain: DomainConfig = dataclasses.field(default_factory=DomainConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    # compute dtype; the polish runs in float64 (f32 L-BFGS diverges).
    # bfloat16 passes validation as in the JAX package, but the kernels
    # take float32 and float64 only.
    dtype: str = "float32"

    def __post_init__(self):
        if self.dtype not in ("float32", "float64", "bfloat16"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
