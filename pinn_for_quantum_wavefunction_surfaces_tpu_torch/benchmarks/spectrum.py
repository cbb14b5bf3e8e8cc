"""Build the excited-state spectrum figure from evaluated surfaces.

The PyTorch counterpart of ``benchmarks/spectrum.py``, on the host only
(numpy and matplotlib; no device). Reads the per-state surfaces that ``cli
evaluate`` writes (keys R, E_int, E_net) from the same ``SOURCES`` table,
the first file of each state's list that exists, relative to the
checkout's root, and draws every state against its exact two-centre ODE
oracle (``analysis.plots.spectrum_figure``) to ``runs/spectrum/
spectrum.pdf`` by default. A state without a surface is skipped with a
note. The shipped ``artifacts/figures/spectrum.pdf`` is the JAX package's.

    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.benchmarks.\\
spectrum [out.pdf]
"""

from __future__ import annotations

import os
import pickle
import sys

from ..analysis import plots
from . import ROOT, RUNS

# state -> candidate surface pickles (first hit wins)
SOURCES = {
    "1ssg": ["artifacts/flagship_separable_energy.pkl",
             "artifacts/energy_eval.pkl"],
    "2psu": ["artifacts/ungerade_separable_energy.pkl"],
    "2ssg": ["artifacts/excited_2ssg_energy.pkl",
             "runs/excited_2ssg_cont/eval/energy_eval.pkl",
             "runs/excited_2ssg/eval/energy_eval.pkl"],
    "3psu": ["artifacts/excited_3psu_energy.pkl",
             "runs/excited_3psu/eval/energy_eval.pkl"],
    "3dsg": ["artifacts/excited_3dsg_energy.pkl",
             "runs/excited_3dsg/eval/energy_eval.pkl",
             "runs/excited_3dsg/energy_eval.pkl"],
    # pi/delta sectors (harmonic transverse factor, ModelConfig.m_abs)
    "2ppu": ["artifacts/pi_2ppu_energy.pkl",
             "runs/pi_2ppu/energy_eval.pkl"],
    "3dpg": ["artifacts/pi_3dpg_energy.pkl",
             "runs/pi_3dpg/energy_eval.pkl"],
    "3ddg": ["artifacts/delta_3ddg_energy.pkl",
             "runs/delta_3ddg/energy_eval.pkl"],
}
OUT = os.path.join(RUNS, "spectrum", "spectrum.pdf")


def main(out: str = OUT, sources: dict = SOURCES, root: str = ROOT) -> str:
    """Draw every state that has a surface; returns the figure's path."""
    states = {}
    for state, paths in sources.items():
        for p in paths:
            p = os.path.join(root, p)
            if os.path.exists(p):
                with open(p, "rb") as f:
                    states[state] = pickle.load(f)
                break
        else:
            print(f"note: no surface for {state}, skipping")
    if not states:
        raise SystemExit("no surfaces found")
    path = plots.spectrum_figure(states, path=out)
    print(path)
    return path


def cli(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    main(argv[0] if argv else OUT)


if __name__ == "__main__":
    cli()
