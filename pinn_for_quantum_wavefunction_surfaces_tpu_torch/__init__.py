"""PyTorch/CUDA port of pinn_for_quantum_wavefunction_surfaces_tpu.

Physics-informed neural-network wavefunctions and eigenvalue surfaces of the
H2+ molecular ion, on PyTorch with hand-written CUDA kernels for NVIDIA
Hopper. This package runs the variational trainers of every family (the
spheroidal polish and the Monte-Carlo trainer, training.variational), the
residual PINN trainer (training.engine) and the E(R) scoring layer: Rayleigh quotients on the uniform, adapted and
spheroidal grids (analysis.energy, with the reference-parity model's
forward-only kernel ops.pallas_residual), the spline E(R) table
(analysis.etab), the E-head distillation (training.distill) and the exact
oracle; npz, the reference's .pt and model.bin checkpoints (io); and the
``variational``, ``train``, ``finetune``, ``energy``, ``distill`` and
``evaluate`` CLI subcommands; the per-R sweep (training.sweep, ``cli
sweep``) and multi-device runs on torch.distributed (parallel: ``--mesh
N``, one rank a device). Separable params run through the kernel of
ops.pallas_separable, 2-input symmetric params through ops.pallas_train;
the minimal family, R-input models and the excited states take the plain
forward-Laplacian pass. The kernels' sources are in csrc/.

Entry points run on CUDA unless the caller passes ``device="cpu"``; a CUDA
request without CUDA raises. The JAX package is the reference: this package
imports nothing of it, nor JAX.
"""

from . import config
from .config import (Config, DomainConfig, ModelConfig, TrainConfig,
                     minimal_config)
from .models.ansatz import from_jax_params, init_params, to_numpy_params

__version__ = "0.1.0"

__all__ = [
    "config", "Config", "ModelConfig", "DomainConfig", "TrainConfig",
    "minimal_config",
    "init_params", "from_jax_params", "to_numpy_params",
]
