"""The one module of the benchmark that imports the program: the PyTorch
and CUDA package, never the JAX package beside it.

It hands the harness the entry classes a cell drives, the program's
configuration built from a configuration file and a traffic file, its
kernel build (``ops/_build.py``: libraries under ``build/kernels/`` in the
checkout) and its launch counters.
"""

from __future__ import annotations

import dataclasses
import importlib

PORT = "pinn_for_quantum_wavefunction_surfaces_tpu_torch"
# the program's kernels by the names of their sources (csrc/<name>.cu);
# the device trace's kernel names carry them
KERNELS = {"K1": ("separable_fwd", "separable_bwd"),
           "K2": ("train_fwd", "train_bwd"),
           "K3": ("residual_fwd",)}


def module(name: str):
    """The program's module ``name`` (dotted, under the package)."""
    return importlib.import_module(f"{PORT}.{name}")


def build_kernels() -> None:
    """Build K1 and K2 where their libraries are missing, else nothing."""
    b = module("ops._build")
    b.build([n for k in ("K1", "K2") for n in KERNELS[k]])


def config(cfg: dict, traffic: dict):
    """The program's ``Config`` of a configuration file's model and domain
    and a traffic file's schedule and type."""
    c = module("config")
    train = {k: (tuple(v) if k == "betas" else v)
             for k, v in traffic.get("train", {}).items()}
    return c.Config(model=c.ModelConfig(**cfg["model"]),
                    domain=c.DomainConfig(**cfg["domain"]),
                    train=dataclasses.replace(c.TrainConfig(), **train),
                    convention=cfg.get("convention", "poc"),
                    dtype=traffic["dtype"])


def launches() -> int:
    """Kernel launches the wrappers of K1, K2 and K3 have counted."""
    return sum(sum(module(m).launches.values()) for m in
               ("ops.pallas_separable", "ops.pallas_train",
                "ops.pallas_residual"))


def kernel_of(name: str) -> str | None:
    """"K1", "K2" or "K3" for a device kernel built from the program's
    ``csrc/``, else None."""
    for k, srcs in KERNELS.items():
        if any(s in name for s in srcs):
            return k
    return None
