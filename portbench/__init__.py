"""The benchmark of the PyTorch and CUDA port
(``pinn_for_quantum_wavefunction_surfaces_tpu_torch``) on one NVIDIA H100:
``python3 -m portbench.run``. It imports neither JAX nor the JAX package;
the reference (``portbench.reference``) imports nothing of the program.
"""
