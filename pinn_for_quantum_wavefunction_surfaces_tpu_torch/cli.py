"""Command-line interface of the PyTorch port.

    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli train \\
        --out runs/flagship --epochs 20000 --gz --trainable-exponent \\
        --lr-schedule step
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli finetune \\
        runs/flagship/best.npz --out runs/ft --dtype float64
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli variational \\
        --arch separable --spheroidal --adam-warmup 1500 --lbfgs 800 \\
        --n-r 39 --n-xi 40 --n-eta 24 --dtype float64

``train`` and ``finetune`` run the residual PINN trainer of the symmetric
family (stage 1, then the E-head fine-tune); ``variational`` runs the
separable-spheroidal polish (Adam warmup, then L-BFGS with best-iterate
selection on a third grid). Each runs on the card, or on the CPU with
``--device cpu``, and writes the JAX package's files (npz checkpoint layout,
meta keys, history pickle, final JSON line). The other subcommands of the
JAX package are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np


def _build_cfg(args):
    """Config from the parsed flags; a flag a subcommand lacks keeps the
    default."""
    from .config import Config, DomainConfig, ModelConfig, TrainConfig

    def given(*names):
        return {n: getattr(args, n) for n in names
                if getattr(args, n, None) not in (None, False)}

    model = ModelConfig(
        arch=args.arch, inversion_symmetry=1 if args.state == "gerade" else -1,
        **given("hidden", "wide_alpha", "trainable_exponent", "gz",
                "r_input"))
    domain = DomainConfig(**given("fixed_r", "xi_span", "r_cluster",
                                  "sampler", "focus_frac", "focus_scale",
                                  "focus_floor"))
    for key, val in (("r_lo", args.dom_r_lo), ("r_hi", args.dom_r_hi)):
        if val is not None:
            domain = dataclasses.replace(domain, **{key: val})
    train = TrainConfig(**given("n_train", "epochs", "lr", "seed",
                                "lr_schedule", "resample_frac", "sc_step",
                                "sc_decay", "ema_decay", "residual_weight",
                                "scale_invariant", "correction_reg"))
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
        params = {k: {kk: np.asarray(vv, cfg.dtype) for kk, vv in v.items()}
                  for k, v in _load_params(args.checkpoint).items()}
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


def _residual_cfg(args):
    """Config of the residual trainer; exits for what waits for a later
    slice of the port."""
    if args.mesh and args.mesh > 1:
        raise SystemExit("--mesh N > 1 is not ported yet: the multi-device "
                         "slice (ROADMAP Queue 1, multi-device) brings it")
    if args.arch != "symmetric":
        raise SystemExit(f"--arch {args.arch}: the port's residual trainer "
                         "runs the symmetric family; the minimal family "
                         "waits for a later slice (ROADMAP Queue 1, minimal "
                         "and r_input families)")
    if args.r_input:
        raise SystemExit("--r-input is not ported yet: it waits for a later "
                         "slice (ROADMAP Queue 1, minimal and r_input "
                         "families)")
    return _build_cfg(args)


def _load_params(path: str) -> dict:
    from .io import checkpoint
    if not path.endswith(".npz"):
        raise SystemExit("the port reads .npz checkpoints only")
    params, _ = checkpoint.load_params(path)
    return params.get("params", params)


def cmd_train(args) -> None:
    """Stage-1 residual training (the paper schedule by default)."""
    from .io import checkpoint
    from .training import engine
    from .utils.metrics import MetricLogger, save_history
    cfg = _residual_cfg(args)
    os.makedirs(args.out, exist_ok=True)
    log = MetricLogger(os.path.join(args.out, "metrics.jsonl"))

    def ckpt_cb(state, step):
        checkpoint.save(os.path.join(args.out, "best.npz"),
                        {"params": state.best_params},
                        meta={"step": step,
                              "best_loss": float(state.best_loss)})
        # full training state (params + Adam moments) for exact resume, in
        # the JAX package's keys (opt/0/count, opt/0/mu/..., opt/1/count)
        checkpoint.save(os.path.join(args.out, "state.npz"),
                        {"params": state.params, "opt": state.opt_state},
                        meta={"step": step})

    params = opt_state = None
    start_step = 0
    if args.resume:
        if args.resume.endswith("state.npz"):
            tree, meta = checkpoint.load_params(args.resume)
            params, opt_state = tree["params"], tree["opt"]
            start_step = int(meta.get("step", 0))
        else:
            params = _load_params(args.resume)
    res = engine.train(cfg, params=params, opt_state=opt_state,
                       start_step=start_step, log_cb=log,
                       checkpoint_cb=ckpt_cb, device=args.device)
    log.close()
    checkpoint.save(os.path.join(args.out, "final.npz"),
                    {"params": res.params},
                    meta={"best_loss": res.best_loss,
                          "runtime_s": res.runtime_s})
    checkpoint.save(os.path.join(args.out, "best.npz"),
                    {"params": res.best_params},
                    meta={"best_loss": res.best_loss})
    if cfg.train.ema_decay > 0:
        checkpoint.save(os.path.join(args.out, "ema.npz"),
                        {"params": res.ema_params}, meta={})
    save_history(os.path.join(args.out, "history.pkl"), res.history)
    print(json.dumps({"best_loss": res.best_loss,
                      "runtime_s": round(res.runtime_s, 2),
                      "points_per_sec": round(res.points_per_sec, 1)}))


def cmd_finetune(args) -> None:
    """Stage-2: freeze everything but the E head and train it."""
    from .config import finetune_config
    from .io import checkpoint
    from .training import engine
    from .utils.metrics import save_history
    cfg = finetune_config(_residual_cfg(args))
    if args.epochs:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, epochs=args.epochs))
    params = _load_params(args.checkpoint)
    os.makedirs(args.out, exist_ok=True)
    res = engine.finetune(cfg, params=params, log_cb=_log,
                          device=args.device)
    checkpoint.save(os.path.join(args.out, "finetune.npz"),
                    {"params": res.best_params},
                    meta={"best_loss": res.best_loss})
    save_history(os.path.join(args.out, "history_finetune.pkl"), res.history)
    print(json.dumps({"best_loss": res.best_loss}))


def _add_common(p):
    p.add_argument("--device", default="cuda",
                   help="cuda (the Hopper kernels; raises without CUDA) or "
                        "cpu (the plain PyTorch path)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--arch", default="symmetric",
                   choices=["symmetric", "minimal", "separable"])
    p.add_argument("--state", default="gerade",
                   choices=["gerade", "ungerade"])
    p.add_argument("--hidden", type=int,
                   help="correction-MLP width (default 16)")
    p.add_argument("--seed", type=int, help="init seed (default 12345)")
    p.add_argument("--r-lo", type=float, dest="dom_r_lo")
    p.add_argument("--r-hi", type=float, dest="dom_r_hi")
    p.add_argument("--fixed-r", type=float, dest="fixed_r")


def _add_residual(p):
    """The flags of the residual trainer (train, finetune)."""
    _add_common(p)
    p.add_argument("--n-train", type=int, dest="n_train")
    p.add_argument("--epochs", type=int,
                   help="TOTAL schedule length; a resumed run trains the "
                        "remaining epochs - start_step steps")
    p.add_argument("--lr", type=float)
    p.add_argument("--sampler", choices=["uniform", "mixed"],
                   help="mixed = nucleus-focused importance sampling")
    p.add_argument("--focus-frac", type=float, dest="focus_frac")
    p.add_argument("--focus-scale", type=float, dest="focus_scale")
    p.add_argument("--focus-floor", type=float, dest="focus_floor")
    p.add_argument("--sc-step", type=int, dest="sc_step")
    p.add_argument("--sc-decay", type=float, dest="sc_decay")
    p.add_argument("--ema-decay", type=float, dest="ema_decay",
                   help="Polyak averaging decay (e.g. 0.999; 0 = off)")
    p.add_argument("--residual-weight", choices=["none", "lcao"],
                   dest="residual_weight",
                   help="lcao = local-energy-variance weighting")
    p.add_argument("--scale-invariant", action="store_true",
                   dest="scale_invariant",
                   help="normalise the loss by mean(psi^2)")
    p.add_argument("--correction-reg", type=float, dest="correction_reg",
                   help="penalty keeping the neural correction small "
                        "relative to LCAO (e.g. 1e-3)")
    p.add_argument("--trainable-exponent", action="store_true",
                   dest="trainable_exponent",
                   help="learn the orbital exponent alpha(R)")
    p.add_argument("--r-input", action="store_true", dest="r_input",
                   help="feed R into the correction MLP (not ported yet)")
    p.add_argument("--gz", action="store_true",
                   help="Guillemin-Zener physics part e^{-a r1 - b r2} "
                        "with trainable b(R) (LCAO is b=0)")
    p.add_argument("--lr-schedule", choices=["none", "step"],
                   dest="lr_schedule",
                   help="step = exponential decay (sc_step/sc_decay)")
    p.add_argument("--resample-frac", type=float, dest="resample_frac")
    p.add_argument("--mesh", type=int, default=0,
                   help="devices to shard the batch over (only 0 or 1 in "
                        "this port so far)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="stage-1 residual training")
    _add_residual(p)
    p.add_argument("--out", default="runs/stage1")
    p.add_argument("--resume",
                   help="checkpoint to warm-start from (params-only), or a "
                        "state.npz for exact resume incl. optimizer state")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("finetune", help="stage-2 E-head fine-tune")
    _add_residual(p)
    p.add_argument("checkpoint")
    p.add_argument("--out", default="runs/stage2")
    p.set_defaults(fn=cmd_finetune)

    p = sub.add_parser("variational",
                       help="spheroidal Rayleigh-quotient polish")
    p.add_argument("checkpoint", nargs="?",
                   help="warm-start .npz checkpoint (default: GZ init)")
    p.add_argument("--out", default="runs/variational")
    _add_common(p)
    p.add_argument("--wide-alpha", action="store_true", dest="wide_alpha",
                   help="orbital exponent alpha(R) in (0.3, 2.25)")
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
