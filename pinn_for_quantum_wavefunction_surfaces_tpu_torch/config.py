"""Typed, immutable configuration of the PyTorch port.

A copy of the fields of ``pinn_for_quantum_wavefunction_surfaces_tpu.config``
that the port's two trainers read (the separable-spheroidal variational
polish and the residual PINN trainer of the symmetric family), with the same
defaults and the same validation. The port keeps its own copy: it imports
nothing of the JAX package.

Conventions (as in the JAX package):
- ``R`` is the *half* internuclear distance; the nuclei sit at
  ``(+/-R, +/-ry, +/-rz)``. Total energy = E_electronic + 1/(2R).
- All lengths in Bohr, energies in Hartree.

There is no kernel switch: a CUDA tensor goes through the Hopper kernels, a
CPU tensor through their plain PyTorch versions. The JAX package's
``TrainConfig.remat`` (an XLA rematerialisation switch) has no meaning here
and is not copied.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the parametric ansatz psi(x, y, z; R).

    Defaults mirror the paper model: correction MLP 2->16->16 (sigmoid),
    output head 16->1, gate 1->10->1, eigenvalue head 1->32->32->1 with
    output bias initialised to -1.

    Three families: ``symmetric`` (psi = gate(R) NN_sym + LCAO or
    Guillemin-Zener, with ``trainable_exponent``, ``gz`` and ``r_input``),
    ``minimal`` (psi = f1 + f2 + gate(R) NN(f1, f2), no mirrored branch)
    and ``separable`` (psi = Phi_GZ exp(l(xi; R) + m(eta^2; R))), the
    latter with its excited-state factors: radial nodes (``xi_node``,
    ``xi_node2``), an angular node (``eta_node``) and the transverse factor
    of an |m| state (``m_abs``).
    """

    arch: str = "symmetric"
    hidden: int = 16         # correction-MLP width
    hidden_e: int = 32       # eigenvalue-head width
    hidden_gate: int = 10    # gate width
    inversion_symmetry: int = 1  # P = +1 gerade (1s sigma_g), -1 ungerade
    ry: float = 0.0          # nuclei offset in y
    rz: float = 0.0          # nuclei offset in z
    eout_bias_init: float = -1.0
    # trainable orbital exponent alpha(R) on the envelopes e^{-alpha r}
    trainable_exponent: bool = False
    hidden_alpha: int = 8    # width of the alpha(R) and b(R) heads
    # feed R/4 into the correction MLP (symmetric/minimal families)
    r_input: bool = False
    # Guillemin-Zener physics part e^{-a r1 - b r2} + P e^{-a r2 - b r1}
    gz: bool = False
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
    """Collocation and quadrature domain."""

    box: float = 18.0        # half-width of the sampling cube
    bc_cutoff: float = 17.5  # boundary-decay penalty radius
    r_lo: float = 0.2        # half-distance range lower bound
    r_hi: float = 4.0        # upper bound
    cutoff: float = 0.005    # nuclear-singularity clamp
    # prolate-spheroidal quadrature extent (absolute, bohr): xi covers
    # r1 + r2 up to 2R + 2 * xi_span
    xi_span: float = 20.0
    # R-row layout: "uniform" = linspace(r_lo, r_hi, n_r); "log" clusters
    # rows in log(R + 0.3) toward the united-atom end
    r_cluster: str = "uniform"
    fixed_r: Optional[float] = None  # train at one R
    # collocation measure: "uniform" over the +-box cube, or "mixed":
    # focus_frac of the points from exponential shells (radius floor +
    # Gamma(3, focus_scale)) around the two nuclei, the rest uniform
    sampler: str = "uniform"
    focus_frac: float = 0.3
    focus_scale: float = 1.0
    focus_floor: float = 0.15


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation schedule of the residual trainer (training.engine);
    the variational polish reads ``seed`` only."""

    n_train: int = 100_000       # collocation batch size
    n_test: int = 80             # quadrature grid points per axis
    epochs: int = 5_000
    lr: float = 8e-3
    resample_every: int = 1
    resample_frac: float = 0.9   # resampling stops after this fraction
    best_after_frac: float = 0.5  # persist best only after this fraction
    seed: int = 12345
    lr_schedule: str = "none"    # "none" | "step" (staircase decay)
    sc_step: int = 3000
    sc_decay: float = 0.7
    ema_decay: float = 0.0       # Polyak average of the params (0 = off)
    residual_weight: str = "none"   # "none" | "lcao"
    residual_weight_floor: float = 0.05
    scale_invariant: bool = False   # divide L_pde, L_bc by mean(psi^2)
    correction_reg: float = 0.0     # lambda mean((psi-LCAO)^2)/mean(LCAO^2)
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    scan_chunk: int = 250        # steps between host reads (logging, best)


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level config: model + domain + training + numerics."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    domain: DomainConfig = dataclasses.field(default_factory=DomainConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    # residual convention: "poc" res = (H - E) psi; "minimal" res = lap psi
    # + (e + 1/r1 + 1/r2) psi (ops.operators.RESIDUALS)
    convention: str = "poc"
    # compute dtype; the polish runs in float64 (f32 L-BFGS diverges)
    dtype: str = "float32"

    def __post_init__(self):
        if self.convention not in ("poc", "minimal"):
            raise ValueError(f"unknown convention {self.convention!r}")
        if self.dtype not in ("float32", "float64", "bfloat16"):
            raise ValueError(f"unknown dtype {self.dtype!r}")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def paper_config(**overrides) -> Config:
    """The configuration of the paper run (the defaults)."""
    return Config(**overrides)


def minimal_config(**overrides) -> Config:
    """The configuration of the minimal trainer (the reference's
    ``train.py``): 10 000 points, R in [0.2, 3], 1 000 epochs resampled
    every epoch to the end, the ``minimal`` family and residual
    convention."""
    base = Config(
        model=ModelConfig(arch="minimal"),
        domain=DomainConfig(r_hi=3.0),
        train=TrainConfig(n_train=10_000, epochs=1_000, resample_frac=1.0),
        convention="minimal",
    )
    return dataclasses.replace(base, **overrides)


def finetune_config(base: Config | None = None, **overrides) -> Config:
    """Stage-2 fine-tune schedule: lr 5e-4, 2000 epochs, same batch size;
    the wavefunction nets are frozen by ``training.engine.finetune``."""
    base = base or Config()
    cfg = dataclasses.replace(
        base, train=dataclasses.replace(base.train, lr=5e-4, epochs=2_000))
    return dataclasses.replace(cfg, **overrides)


def smoke_config(**overrides) -> Config:
    """Tiny config for tests: small batch, few epochs."""
    base = Config(train=TrainConfig(n_train=512, epochs=20, scan_chunk=10))
    return dataclasses.replace(base, **overrides)
