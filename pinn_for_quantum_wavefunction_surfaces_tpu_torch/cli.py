"""Command-line interface of the PyTorch port.

    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli variational \\
        --arch separable --spheroidal --adam-warmup 1500 --lbfgs 800 \\
        --n-r 39 --n-xi 40 --n-eta 24 --dtype float64

runs the separable-spheroidal polish (Adam warmup, then L-BFGS with
best-iterate selection on a third grid) on the card, or on the CPU with
``--device cpu``, and writes ``variational.npz`` in the JAX package's
checkpoint layout with the same meta keys. Only this subcommand is ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np


def _build_cfg(args):
    from .config import Config, DomainConfig, ModelConfig, TrainConfig
    model = ModelConfig(
        arch=args.arch, inversion_symmetry=1 if args.state == "gerade" else -1,
        wide_alpha=args.wide_alpha,
        **({"hidden": args.hidden} if args.hidden else {}))
    domain = DomainConfig()
    for key, val in (("r_lo", args.dom_r_lo), ("r_hi", args.dom_r_hi),
                     ("fixed_r", args.fixed_r), ("xi_span", args.xi_span),
                     ("r_cluster", args.r_cluster)):
        if val is not None:
            domain = dataclasses.replace(domain, **{key: val})
    train = TrainConfig() if args.seed is None else TrainConfig(seed=args.seed)
    return Config(model=model, domain=domain, train=train, dtype=args.dtype)


def _log(step, metrics):
    # 9 significant digits: polish progress is sub-mHa on an O(1) Ha
    # objective
    print(f"{step:8d}: " + " ".join(f"{k}={v:.9e}" for k, v in
                                    metrics.items()), flush=True)


def cmd_variational(args) -> None:
    """Spheroidal variational polish of a checkpoint or of the GZ init."""
    from .io import checkpoint
    from .models import ansatz
    from .training import variational
    cfg = _build_cfg(args)
    if cfg.model.arch != "separable":
        raise SystemExit("the port runs the separable family only: pass "
                         "--arch separable")
    if not args.spheroidal:
        raise SystemExit("the port runs the deterministic --spheroidal "
                         "objective only (the Monte-Carlo trainer is not "
                         "ported)")
    if not (args.lbfgs or args.adam_warmup):
        raise SystemExit("--spheroidal is the deterministic objective: give "
                         "it an optimisation budget (--lbfgs N and/or "
                         "--adam-warmup N)")
    params = None
    if args.checkpoint:
        if not args.checkpoint.endswith(".npz"):
            raise SystemExit("the port reads .npz checkpoints only")
        loaded, _ = checkpoint.load_params(args.checkpoint)
        params = {k: {kk: np.asarray(vv, cfg.dtype) for kk, vv in v.items()}
                  for k, v in loaded.get("params", loaded).items()}
    os.makedirs(args.out, exist_ok=True)
    polished = variational.polish_spheroidal(
        params, cfg, n_r=args.n_r, n_xi=args.n_xi, n_eta=args.n_eta,
        steps=args.lbfgs, adam_steps=args.adam_warmup,
        warmup_save=os.path.join(args.out, "warmup.npz"),
        best_save=os.path.join(args.out, "best_sofar.npz"),
        log_cb=_log, memory_size=args.lbfgs_memory, device=args.device)
    polish = "spheroidal-lbfgs" if args.lbfgs else "spheroidal-adam"
    meta = {"polish": polish}
    if cfg.domain.xi_span != 20.0:
        # non-default quadrature extent is part of the objective
        meta["xi_span"] = cfg.domain.xi_span
    if cfg.domain.r_cluster != "uniform":
        meta["r_cluster"] = cfg.domain.r_cluster
    if (cfg.domain.r_lo, cfg.domain.r_hi) != (0.2, 4.0):
        meta["r_lo"] = cfg.domain.r_lo
        meta["r_hi"] = cfg.domain.r_hi
    checkpoint.save(os.path.join(args.out, "variational.npz"),
                    {"params": ansatz.to_numpy_params(polished)}, meta=meta)
    print(json.dumps({"out": args.out, "polish": polish,
                      "lbfgs_steps": args.lbfgs,
                      "adam_warmup_steps": args.adam_warmup,
                      "deflated": False, "spheroidal": True,
                      "device": args.device}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("variational",
                       help="spheroidal Rayleigh-quotient polish")
    p.add_argument("checkpoint", nargs="?",
                   help="warm-start .npz checkpoint (default: GZ init)")
    p.add_argument("--out", default="runs/variational")
    p.add_argument("--device", default="cuda",
                   help="cuda (the Hopper kernels; raises without CUDA) or "
                        "cpu (the plain PyTorch path)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--arch", default="symmetric",
                   choices=["symmetric", "minimal", "separable"])
    p.add_argument("--state", default="gerade",
                   choices=["gerade", "ungerade"])
    p.add_argument("--wide-alpha", action="store_true", dest="wide_alpha",
                   help="orbital exponent alpha(R) in (0.3, 2.25)")
    p.add_argument("--hidden", type=int,
                   help="correction-MLP width (default 16)")
    p.add_argument("--seed", type=int, help="init seed (default 12345)")
    p.add_argument("--r-lo", type=float, dest="dom_r_lo")
    p.add_argument("--r-hi", type=float, dest="dom_r_hi")
    p.add_argument("--fixed-r", type=float, dest="fixed_r")
    p.add_argument("--xi-span", type=float, dest="xi_span")
    p.add_argument("--r-cluster", dest="r_cluster",
                   choices=["uniform", "log"])
    p.add_argument("--spheroidal", action="store_true",
                   help="deterministic objective: exact per-R quotients on "
                        "prolate-spheroidal Gauss grids")
    p.add_argument("--n-r", type=int, default=32, dest="n_r")
    p.add_argument("--n-xi", type=int, default=48, dest="n_xi")
    p.add_argument("--n-eta", type=int, default=48, dest="n_eta")
    p.add_argument("--adam-warmup", type=int, default=0, dest="adam_warmup",
                   help="deterministic-Adam steps before the L-BFGS polish")
    p.add_argument("--lbfgs", type=int, default=0,
                   help="L-BFGS polish steps")
    p.add_argument("--lbfgs-memory", type=int, default=15,
                   dest="lbfgs_memory", help="L-BFGS curvature-memory size")
    p.set_defaults(fn=cmd_variational)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
