"""The port's counterparts of the repo's ``benchmarks/`` scripts.

Each module runs with ``python -m
pinn_for_quantum_wavefunction_surfaces_tpu_torch.benchmarks.<name>``, on
the card unless given ``--device cpu``, and writes its files under
``runs/`` at the checkout's root. Sizes, paths and R grids are parameters
of each module's ``main(...)``, with the JAX scripts' values as defaults.
"""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RUNS = os.path.join(ROOT, "runs")
