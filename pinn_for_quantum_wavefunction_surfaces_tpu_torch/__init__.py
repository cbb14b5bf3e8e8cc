"""PyTorch/CUDA port of pinn_for_quantum_wavefunction_surfaces_tpu.

Physics-informed neural-network wavefunctions and eigenvalue surfaces of the
H2+ molecular ion, on PyTorch with hand-written CUDA kernels for NVIDIA
Hopper. This package runs the separable-spheroidal variational trainer: the
ansatz (models.ansatz), the fused (psi, lap psi) kernel with its backward
(ops.pallas_separable, csrc/), the exact quadrature objective and its
Adam + L-BFGS polish (training.variational), spheroidal scoring and the
exact oracle (analysis), npz checkpoints (io.checkpoint) and the
``variational`` CLI.

Entry points run on CUDA unless the caller passes ``device="cpu"``; a CUDA
request without CUDA raises. The JAX package is the reference: this package
imports nothing of it, nor JAX.
"""

from . import config
from .config import Config, DomainConfig, ModelConfig, TrainConfig
from .models.ansatz import from_jax_params, init_params, to_numpy_params

__version__ = "0.1.0"

__all__ = [
    "config", "Config", "ModelConfig", "DomainConfig", "TrainConfig",
    "init_params", "from_jax_params", "to_numpy_params",
]
