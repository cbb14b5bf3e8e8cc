"""Score the reference-recipe replication runs.

The PyTorch counterpart of ``benchmarks/ref_recipe_score.py``. Each seed in
``runs/ref_recipe/s*`` was trained with the reference's float64 schedule
(``make ref-recipe``: plain residual loss, then the E-head fine-tune).
This scores each stage-2 checkpoint's E_net and E_int against the exact
ODE oracle on the 96 x 96 prolate-spheroidal grid (``analysis.energy
.surface(..., lcao=False, grid="spheroidal")``, float64) and prints one
JSON line per seed with the JAX script's keys. The checkpoints hold
reference-parity params, so on the card every model quotient runs through
K3 (``csrc/residual_fwd.cu``, ``routing.psi_lap_forward``).

    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.benchmarks.\\
ref_recipe_score [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from ..analysis import energy as aen
from ..config import Config
from ..device import DEVICE_HELP, resolve_device
from ..io import checkpoint
from ..models import ansatz
from . import RUNS

REF_RECIPE_RUNS = os.path.join(RUNS, "ref_recipe")


def score(path: str, device="cuda", r_values=None) -> dict:
    """The unrounded scores (mHa) of one stage-2 checkpoint."""
    dev = resolve_device(device)
    cfg = Config(dtype="float64")
    tree, _ = checkpoint.load_params(path)
    params = ansatz.as_params(tree.get("params", tree), torch.float64, dev)
    surf = aen.surface(params, cfg, r_values=r_values, lcao=False,
                       grid="spheroidal")
    exact = aen.exact_energy_ode(surf["R"])
    e_net = 1e3 * (surf["E_net"] - exact)
    e_int = 1e3 * (surf["E_int"] - exact)
    sel = surf["R"] >= 0.5
    return {
        "net_mean_mHa": float(np.abs(e_net).mean()),
        "net_max_mHa": float(np.abs(e_net).max()),
        "net_mean_mHa_R>=0.5": float(np.abs(e_net[sel]).mean()),
        "int_mean_mHa": float(np.abs(e_int).mean()),
        "int_max_mHa": float(np.abs(e_int).max()),
        "int_min_signed_mHa": float(e_int.min()),
    }


def main(root: str = REF_RECIPE_RUNS, device="cuda",
         r_values=None) -> list[dict]:
    """Score every ``root/s*/stage2/finetune.npz``: one JSON line each,
    rounded as the JAX script prints them; returns the unrounded rows."""
    resolve_device(device)
    rows = []
    for run in sorted(glob.glob(os.path.join(root, "s*", "stage2",
                                             "finetune.npz"))):
        row = {"run": os.path.relpath(run, root),
               **score(run, device, r_values)}
        rows.append(row)
        print(json.dumps({k: v if k == "run" else round(v, 3)
                          for k, v in row.items()}), flush=True)
    return rows


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help=DEVICE_HELP)
    main(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    cli()
