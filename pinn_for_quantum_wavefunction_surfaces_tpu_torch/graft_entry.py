"""Compile-check entry and multi-device dry run.

The PyTorch counterpart of the root ``__graft_entry__.py``:

- ``entry(device)``: ``(fn, (params, batch))``, the fused forward and
  residual loss of the flagship separable family on 8 192 points (float32):
  ``fn(params, batch)`` gives ``(l, l_pde, l_bc)`` through
  ``losses.loss_fn``, which on the card is K1 (``csrc/separable_fwd.cu``).
- ``dryrun_multichip(n_devices, device)``: one sharded training step and
  the sharded spheroidal polish on ``n_devices`` ranks
  (``parallel.mesh.launch``: NCCL on cards, gloo under ``device="cpu"``),
  each held against the same run on one device, to the JAX dry run's
  tolerances.

The JAX dry run checks two sharded paths of its training step, GSPMD and
``shard_map``. The port's counterparts, ``engine.train(mesh=)`` and
``parallel.mesh.make_shardmap_step``, differ only in how a rank draws a
fresh batch (the global batch's block, or its own sub-batch); with
resampling off, as here, both advance ``engine.Trainer`` on the rank's
block of the same batch: one code path, run once.

The polish runs in float64, where the JAX dry run's is float32. At the
separable init the output layers are zero and the quotient does not
change with the scale of psi, so the gradient of ``lamout.b`` and
``muout.b`` is zero but for roundoff: 3.2e-8 in float32 against a largest
gradient of 0.17, near Adam's eps of 1e-8, where Adam's step
lr g / (|g| + eps) follows the roundoff itself. So in float32 one device
does not reproduce its own polish when only the order of its sums
changes: with the points of every quadrature row reversed, those biases
move by 4.2e-4 in three steps, and ``lam2``, ``mu2`` and ``muout`` move
with them past rtol 1e-5. In float64 the reversal moves no leaf by more
than 1e-10 (tests/test_torch_entry_points.py prints these readings), and
the sharded polish agrees to 1e-11; the flagship polish runs in float64
(``make flagship``).

    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.graft_entry \\
        [dryrun N] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from . import config
from .device import resolve_device
from .models import ansatz
from .ops.sampling import sample_batch
from .parallel import mesh as pmesh
from .training import engine, losses, variational

ENTRY_POINTS = 8192


def entry(device="cuda"):
    """(fn, example_args): the fused psi, lap psi, E pass and the (H - E)
    psi residual loss of the flagship separable family (the training hot
    path), float32, 8 192 points drawn by ``sample_batch`` from seed 0."""
    dev = resolve_device(device)
    cfg = config.Config(model=config.ModelConfig(arch="separable"),
                        dtype="float32")
    params = ansatz.init_params(cfg.model, seed=0, dtype=torch.float32,
                                device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = sample_batch(gen, cfg, n=ENTRY_POINTS, device=dev)

    def fn(params, batch):
        with torch.no_grad():
            l, aux = losses.loss_fn(params, cfg, batch)
        return l, aux.l_pde, aux.l_bc

    return fn, (params, batch)


def _dryrun_cfgs(n_devices: int):
    """The dry run's training config (smoke_config, float32, 64 points a
    device, resampling off) and the polish's (separable, float64)."""
    cfg = config.smoke_config(dtype="float32")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, n_train=64 * n_devices, epochs=4, scan_chunk=2,
        resample_frac=0.0))
    cfg_sep = config.Config(dtype="float64",
                            model=config.ModelConfig(arch="separable"))
    return cfg, cfg_sep


def _frozen(gen):
    raise AssertionError("the dry run trains on a frozen batch")


def _check_close(label: str, got: dict, want: dict, rtol: float,
                 atol: float) -> float:
    """Raise unless every leaf of ``got`` is within atol + rtol |want| of
    ``want``'s; returns the largest absolute difference."""
    worst = 0.0
    for k in sorted(want):
        for f in sorted(want[k]):
            a = got[k][f].detach().cpu().numpy()
            b = want[k][f].detach().cpu().numpy()
            if not np.allclose(a, b, rtol=rtol, atol=atol):
                raise AssertionError(
                    f"{label}: {k}/{f} differs by "
                    f"{float(np.max(np.abs(a - b))):.3e} (rtol {rtol}, "
                    f"atol {atol})")
            worst = max(worst, float(np.max(np.abs(a - b))))
    return worst


def _dryrun_rank(mesh) -> dict:
    """One rank of the dry run: the sharded step and polish against the
    same on this rank's device alone; raises on a mismatch."""
    dev = mesh.device
    cfg, cfg_sep = _dryrun_cfgs(mesh.size)
    params = ansatz.init_params(cfg.model, seed=0, dtype=torch.float32,
                                device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = sample_batch(gen, cfg, device=dev)
    state = engine.TrainState(1, params, None, batch, None, None, None,
                              None)

    # single-device reference step from the same state and batch
    single = engine.Trainer(cfg, params, start_step=1, batch=batch,
                            device=dev)
    l_ref = float(single.advance(_frozen).l_tot)
    # the sharded step: the rank's block, the loss's sums and the gradient
    # all-reduced
    trainer = pmesh.shard_state(state, cfg, mesh)
    step, _ = pmesh.make_shardmap_step(cfg, mesh)
    l_mesh = float(step(trainer).l_tot)
    if not (l_ref > 0 and abs(l_mesh - l_ref) <= 1e-5 * abs(l_ref)):
        raise AssertionError(f"the sharded step's loss {l_mesh} against "
                             f"one device's {l_ref}")
    step_diff = _check_close("the sharded step's params",
                             trainer.state().params, single.state().params,
                             rtol=1e-5, atol=1e-8)

    # the flagship path: the R-row sharded spheroidal polish against the
    # single-device polish from the same init (n_r = N: every rank one row)
    p0 = ansatz.init_params(cfg_sep.model, seed=1, dtype=torch.float64,
                            device=dev)
    kw = dict(n_r=mesh.size, n_xi=8, n_eta=6, steps=0, adam_steps=3)
    p_single = variational.polish_spheroidal(p0, cfg_sep, device=dev, **kw)
    p_mesh = variational.polish_spheroidal(p0, cfg_sep, mesh=mesh, **kw)
    polish_diff = _check_close("the sharded polish's params", p_mesh,
                               p_single, rtol=1e-5, atol=1e-7)
    return {"ranks": mesh.size, "loss_single": l_ref, "loss_sharded": l_mesh,
            "step_params_max_abs_diff": step_diff,
            "polish_params_max_abs_diff": polish_diff}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One training step (smoke config, float32, 64 points a device,
    resampling off) with the batch sharded over ``n_devices`` ranks, and
    the R-row sharded spheroidal polish (n_r = N, 8 x 6 grid, 3 Adam steps,
    float64, the seed-1 separable init), each against the same on one
    device: the loss to rtol 1e-5, the stepped params to rtol 1e-5 / atol
    1e-8, the polished params to rtol 1e-5 / atol 1e-7. Raises on a
    mismatch; returns rank 0's numbers."""
    return pmesh.launch(_dryrun_rank, int(n_devices), device=device)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if argv and argv[0] == "dryrun":
        n = int(argv[1]) if len(argv) > 1 else 8
        dryrun_multichip(n, device=device)
        print(f"dryrun_multichip({n}) OK")
    else:
        fn, args = entry(device)
        out = fn(*args)
        print("entry OK:", [float(x) for x in out])


if __name__ == "__main__":
    main()
