"""Multi-device scaling of the training step, and a sharded quadrature.

The PyTorch counterpart of ``benchmarks/scaling.py``. For 1, 2, 4 and 8
ranks (as many as the host has devices: CUDA cards, or CPU cores under
``--device cpu``), one rank a device (``parallel.mesh.launch``: NCCL on
cards, gloo on the CPU), it times the training step of the default
symmetric model (float32, ``n`` points a step, resampling every step; K2
on the card) through the port's two sharded paths:

- ``engine_train``: ``engine.train(mesh=)``, where every rank draws the
  global batch and keeps its block (the JAX package's GSPMD layout);
- ``shardmap_step``: ``parallel.mesh.make_shardmap_step``, where each rank
  draws its own n / N points;

one warm-up run of ``steps`` steps, then one timed run, and prints one
JSON line a mesh size. Then, on the largest mesh, the sharded quadrature
demo: ``energy.rayleigh_quotient_sharded`` of the reference-parity model
(K3 on the card) on the uniform ``quad_n``^3 grid (192^3 = 7.08 M points)
at R = 1, its x-slabs split over the ranks. Ranks share one host, so these
times include its launches; on one card there is one row.

    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.benchmarks.\\
scaling [--n 65536] [--steps 20] [--quad-n 192] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from ..analysis import energy as aen
from ..config import Config
from ..device import DEVICE_HELP, resolve_device
from ..models import ansatz
from ..ops.sampling import sample_batch
from ..parallel import mesh as pmesh
from ..training import engine

COUNTS = (1, 2, 4, 8)


def _cfg(n: int, steps: int) -> Config:
    cfg = Config(dtype="float32")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, n_train=n, epochs=10 ** 9, scan_chunk=steps))


def engine_train_rate(mesh, n: int, steps: int) -> float:
    """Points/s of ``engine.train(mesh=)`` over ``steps`` steps, each on a
    fresh global batch (after one warm-up run)."""
    cfg = _cfg(n, steps)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=steps, resample_frac=1.0))
    engine.train(cfg, mesh=mesh)
    return engine.train(cfg, mesh=mesh).points_per_sec


def shardmap_step_rate(mesh, n: int, steps: int) -> float:
    """Points/s of ``make_shardmap_step``'s step over ``steps`` steps (after
    one warm-up chunk), each rank drawing its own sub-batch."""
    cfg = _cfg(n, steps)
    dev = mesh.device
    params = ansatz.init_params(cfg.model, seed=cfg.train.seed,
                                dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    state = engine.TrainState(0, params, None, sample_batch(gen, cfg),
                              None, None, None, None)
    trainer = pmesh.shard_state(state, cfg, mesh)
    step, _ = pmesh.make_shardmap_step(cfg, mesh)

    def chunk() -> float:
        for _ in range(steps):
            hist = step(trainer)
        return float(hist.l_tot)        # a host read: the device is done

    chunk()
    t0 = time.perf_counter()
    chunk()
    return n * steps / (time.perf_counter() - t0)


def sharded_quadrature(mesh, quad_n: int) -> dict:
    """The reference-parity model's E_int at R = 1 on the quad_n^3 grid,
    split over the mesh, and its wall time."""
    cfg = Config(dtype="float32")
    params = ansatz.init_params(cfg.model, seed=0, dtype=torch.float32,
                                device=mesh.device)
    t0 = time.perf_counter()
    e = aen.rayleigh_quotient_sharded(params, cfg, 1.0, mesh, n=quad_n)
    return {"sharded_quadrature_n": quad_n, "points": quad_n ** 3,
            "E_int": float(e), "seconds": round(time.perf_counter() - t0, 2)}


def _row(mesh, n: int, steps: int, quad_n: int | None) -> dict:
    """One mesh size's row (and the quadrature, where asked), on every
    rank."""
    row = {"devices": mesh.size,
           "engine_train_points_per_sec": round(
               engine_train_rate(mesh, n, steps), 1),
           "shardmap_step_points_per_sec": round(
               shardmap_step_rate(mesh, n, steps), 1)}
    quad = None if quad_n is None else sharded_quadrature(mesh, quad_n)
    return {"row": row, "quadrature": quad}


def main(n: int = 65536, steps: int = 20, quad_n: int = 192,
         counts=COUNTS, device="cuda") -> dict:
    """Every row that the host's devices allow, then the quadrature on the
    largest mesh; returns {"rows": [...], "quadrature": {...}}."""
    dev = resolve_device(device)
    have = torch.cuda.device_count() if dev.type == "cuda" else \
        (os.cpu_count() or 1)
    sizes = [c for c in counts if c <= have]
    rows, quad = [], None
    for size in sizes:
        out = pmesh.launch(_row, size, device=dev.type,
                           args=(n, steps,
                                 quad_n if size == sizes[-1] else None))
        rows.append(out["row"])
        print(json.dumps(out["row"]), flush=True)
        quad = out["quadrature"] or quad
    print(json.dumps(quad), flush=True)
    return {"rows": rows, "quadrature": quad}


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--quad-n", type=int, default=192, dest="quad_n",
                    help="per-axis size of the sharded quadrature demo grid")
    ap.add_argument("--device", default="cuda",
                    help=DEVICE_HELP)
    a = ap.parse_args(argv)
    main(a.n, a.steps, a.quad_n, device=a.device)


if __name__ == "__main__":
    cli()
