"""A/B of the forward-only scoring pass: K3 against the eager fwdlap pass.

The PyTorch counterpart of ``benchmarks/pallas_ab.py``. Forward-only
(psi, lap psi) of the reference-parity model (seeded, float32) on ``n``
points uniform in [-18, 18]^3 at R = 2, shaped like the quadrature slabs
of the E(R) surface, through the port's two paths:

- ``k3``: ``ops.pallas_residual.psi_lap_pallas``, one launch of K3
  (``csrc/residual_fwd.cu``) on the card;
- ``fwdlap``: ``models.ansatz.psi_fwdlap``, the eager forward-Laplacian
  pass in plain tensor ops, dozens of launches a call.

Each path runs ``iters`` times a timed call, each iteration's x shifted by
the previous one's mean psi (a data dependence), ``reps`` calls, the
median; then ``max_abs_diff`` of the two paths on the first ``check_n``
points, within ``DIFF_BOUND``. The ratio is no yardstick for K3: it
compares K3 with an eager forward-Laplacian, not with K3's bound (PERF.md,
section 6, gives that).

    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.benchmarks.\\
pallas_ab [--n 1048576] [--reps 20] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import Config
from ..device import DEVICE_HELP, resolve_device
from ..models import ansatz
from ..ops.pallas_residual import psi_lap_pallas

# Both paths' (psi, lap psi) agree to float32 roundoff, 3.7e-8 on an H100.
# The bound sits between that and a planted fault, the fwdlap pass with
# the NN's output weights 0.1% off: chip_smoke.py phase 22d measures both
# on the card and holds the bound between them.
DIFF_BOUND = 1e-6


def inputs(n: int, dev) -> tuple:
    """(cfg, params, x, y, z, r): the reference-parity model (seed 0,
    float32) and n points uniform in [-18, 18]^3 at R = 2, drawn on
    ``dev`` from seed 1."""
    cfg = Config(dtype="float32")
    params = ansatz.init_params(cfg.model, seed=0, dtype=torch.float32,
                                device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x, y, z = (torch.rand(n, generator=gen, device=dev) * 36.0 - 18.0
               for _ in range(3))
    return cfg, params, x, y, z, torch.full((n,), 2.0, device=dev)


def main(n: int = 1_048_576, reps: int = 20, iters: int = 20,
         check_n: int = 4096, device="cuda") -> dict:
    dev = resolve_device(device)
    cfg, params, x, y, z, r = inputs(n, dev)

    def fwdlap_once(x, y, z, r):
        s, _ = ansatz.psi_fwdlap(params, cfg.model, x, y, z, r)
        return s.v[..., 0], s.l[..., 0]

    def k3_once(x, y, z, r):
        return psi_lap_pallas(params, cfg.model, x, y, z, r)

    def looped(once):
        def run() -> float:
            carry = torch.zeros((), device=dev)
            for _ in range(iters):
                psi, lap = once(x + carry * 1e-12, y, z, r)
                carry = torch.mean(psi) + torch.mean(lap) * 0
            return float(carry)         # a host read: the device is done
        return run

    report = {"n": n, "iters_per_call": iters}
    with torch.no_grad():
        for name, once in (("fwdlap", fwdlap_once), ("k3", k3_once)):
            run = looped(once)
            run()                                   # warm-up
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                run()
                times.append(time.perf_counter() - t0)
            dt = float(np.median(times)) / iters
            report[name] = {"ms": round(dt * 1e3, 3),
                            "points_per_sec": round(n / dt, 1)}
        sl = slice(0, check_n)
        ref = fwdlap_once(x[sl], y[sl], z[sl], r[sl])
        got = k3_once(x[sl], y[sl], z[sl], r[sl])
        report["max_abs_diff"] = max(
            float(torch.max(torch.abs(ref[0] - got[0]))),
            float(torch.max(torch.abs(ref[1] - got[1]))))
    report["speedup_k3_vs_fwdlap"] = round(
        report["fwdlap"]["ms"] / report["k3"]["ms"], 3)
    print(json.dumps(report), flush=True)
    if not report["max_abs_diff"] <= DIFF_BOUND:
        raise AssertionError(f"K3 and the fwdlap pass differ by "
                             f"{report['max_abs_diff']:.3e} > {DIFF_BOUND}")
    return report


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help=DEVICE_HELP)
    a = ap.parse_args(argv)
    main(a.n, a.reps, device=a.device)


if __name__ == "__main__":
    cli()
