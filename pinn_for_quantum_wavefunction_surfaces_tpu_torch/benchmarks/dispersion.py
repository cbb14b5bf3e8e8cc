"""Per-R dispersion study: exact family optima against the oracle.

The PyTorch counterpart of ``benchmarks/dispersion.py``. Runs the
deterministic per-R spheroidal polish (``training.sweep.polish_per_r``:
300 L-BFGS steps on the 40 x 24 grid, float64) over the 39-R grid for both
ansatz families:

  - "separable family (per-R optima)" (the flagship family; K1 on the
    card), and
  - "GZ + gate*NN family (per-R optima)" (the symmetric family with the
    Guillemin-Zener physics part and trainable exponents; K2),

prints one JSON line of each family's gap to the exact ODE oracle, writes
the pickle ({label: {R, E_net, best_loss}}) to ``runs/dispersion/
dispersion.pkl``, then draws the variational-gap figure
(``analysis.plots.dispersion_gap_figure``) to ``runs/dispersion/
dispersion.pdf``, with the parametric flagship surface of
``artifacts/energy_eval.pkl`` overlaid where it exists. Drawing needs
matplotlib: without it the figure step raises ``MatplotlibMissing`` after
the pickle is written. The shipped ``artifacts/figures/dispersion.pdf`` is
the JAX package's and is never written here.

    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.benchmarks.\\
dispersion [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from ..analysis import energy as aen
from ..analysis import plots
from ..config import Config, ModelConfig
from ..device import DEVICE_HELP, resolve_device
from ..training import sweep
from . import ROOT, RUNS

FAMILIES = {
    "separable family (per-R optima)": Config(
        dtype="float64", model=ModelConfig(arch="separable")),
    "GZ + gate*NN family (per-R optima)": Config(
        dtype="float64", model=ModelConfig(gz=True, trainable_exponent=True)),
}
R_VALUES = np.round(np.arange(0.2, 4.0 + 1e-9, 0.1), 2)
OUT_DIR = os.path.join(RUNS, "dispersion")
PARAMETRIC = os.path.join(ROOT, "artifacts", "energy_eval.pkl")


def gap_line(label: str, out: dict) -> dict:
    """A family's gap to the exact ODE oracle, as the JAX script prints
    it (mHa)."""
    err = 1e3 * (np.asarray(out["E_net"]) - aen.exact_energy_ode(out["R"]))
    return {"family": label,
            "mean_gap_mHa": round(float(np.abs(err).mean()), 5),
            "max_gap_mHa": round(float(np.abs(err).max()), 5),
            "min_signed_mHa": round(float(err.min()), 6)}


def main(r_values=R_VALUES, steps: int = 300, n_xi: int = 40,
         n_eta: int = 24, out_dir: str = OUT_DIR,
         figure: str | None = None, parametric: str = PARAMETRIC,
         device="cuda") -> dict:
    """Polish every family at every R, print the gap lines, write the
    pickle, then draw the figure (``figure``, default ``out_dir/
    dispersion.pdf``). Returns {label: sweep} (without the params)."""
    resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    sweeps = {}
    for label, cfg in FAMILIES.items():
        print(f"== {label}", flush=True)
        out = sweep.polish_per_r(cfg, r_values, steps=steps, n_xi=n_xi,
                                 n_eta=n_eta, device=device)
        out.pop("params")          # the pickle records the surface only
        sweeps[label] = out
        print(json.dumps(gap_line(label, out)), flush=True)

    with open(os.path.join(out_dir, "dispersion.pkl"), "wb") as f:
        pickle.dump(sweeps, f)
    surf = aen.load_surface(parametric) if os.path.exists(parametric) \
        else None
    path = plots.dispersion_gap_figure(
        sweeps, figure or os.path.join(out_dir, "dispersion.pdf"),
        parametric=surf)
    print(json.dumps({"figure": path}), flush=True)
    return sweeps


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help=DEVICE_HELP)
    main(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    cli()
