"""Command-line interface of the PyTorch port.

    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli train \\
        --out runs/flagship --epochs 20000 --gz --trainable-exponent \\
        --lr-schedule step
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli finetune \\
        runs/flagship/best.npz --out runs/ft --dtype float64
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli variational \\
        --arch separable --spheroidal --adam-warmup 1500 --lbfgs 800 \\
        --n-r 39 --n-xi 40 --n-eta 24 --dtype float64
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli energy \\
        runs/ft/finetune.npz --out energy_R_ion.pkl
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli evaluate \\
        artifacts/flagship_separable.npz --steps 8000 --dtype float64

``train`` and ``finetune`` run the residual PINN trainer of the symmetric
family (stage 1, then the E-head fine-tune); ``variational`` runs the
separable-spheroidal polish (Adam warmup, then L-BFGS with best-iterate
selection on a third grid). ``energy`` extracts the E(R) surface of a
checkpoint (.npz or the reference's .pt), ``distill`` fits the E head to
the Rayleigh quotients of psi, and ``evaluate`` distills, tabulates E(R) as
a spline and scores it against the exact oracle. Each runs on the card, or
on the CPU with ``--device cpu``, and writes the JAX package's files (npz
checkpoint layout, meta keys, history and surface pickles, final JSON
line). The other subcommands of the JAX package are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _build_cfg(args):
    """Config from the parsed flags; a flag a subcommand lacks keeps the
    default."""
    from .config import Config, DomainConfig, ModelConfig, TrainConfig

    def given(*names):
        return {n: getattr(args, n) for n in names
                if getattr(args, n, None) not in (None, False)}

    # the scoring subcommands have no --arch: separable with --m-abs (the
    # only family with pi/delta sectors), else symmetric; their forward
    # dispatch is keyed by the params anyway
    arch = getattr(args, "arch",
                   "separable" if getattr(args, "m_abs", 0) else "symmetric")
    model = ModelConfig(
        arch=arch, inversion_symmetry=1 if args.state == "gerade" else -1,
        **given("hidden", "wide_alpha", "trainable_exponent", "gz",
                "r_input", "m_abs"))
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
    """The param tree (numpy arrays) of a native .npz or a reference .pt."""
    from .io import checkpoint, torch_pt
    if path.endswith(".pt"):
        return torch_pt.load_reference_checkpoint(path)
    if path.endswith(".bin"):
        raise SystemExit("model.bin holds the minimal family, which the port "
                         "cannot score yet (ROADMAP Queue 1, the minimal and "
                         "r_input families; the modelbin reader with them)")
    if not path.endswith(".npz"):
        raise SystemExit("the port reads .npz and .pt checkpoints")
    params, _ = checkpoint.load_params(path)
    return params.get("params", params)


def _scoring_params(args, dtype=None) -> dict:
    """Port params of the checkpoint on ``args.device``; ``dtype`` None
    keeps the checkpoint's own float type."""
    from .models import ansatz
    return ansatz.from_jax_params(_load_params(args.checkpoint), dtype=dtype,
                                  device=args.device)


def cmd_energy(args) -> None:
    """E(R) surface of a checkpoint in the reference's pickle schema, with
    E_net's error against the exact energies."""
    from .analysis import energy as aen
    if args.figure:
        raise SystemExit("--figure needs analysis/plots and matplotlib, not "
                         "ported yet (ROADMAP Queue 1, the rest of analysis "
                         "and io)")
    cfg = _build_cfg(args)
    params = _scoring_params(args)
    surf = aen.surface(params, cfg, n=args.n_test, lcao=not args.no_lcao,
                       grid=args.grid,
                       progress=lambda i, n, ri: print(
                           f"R={ri:.1f} ({i + 1}/{n})", file=sys.stderr))
    aen.save_surface(args.out, surf)
    exact = aen.exact_energy(surf["R"], oracle=args.oracle)
    err = 1e3 * np.abs(surf["E_net"] - exact)
    print(json.dumps({"surface": args.out,
                      "oracle": args.oracle,
                      "max_err_mHa": round(float(err.max()), 3),
                      "mean_err_mHa": round(float(err.mean()), 3)}))


def cmd_distill(args) -> None:
    """Fit the E(R) head to the Rayleigh quotient of the trained psi."""
    from .io import checkpoint
    from .models import ansatz
    from .training import distill
    cfg = _build_cfg(args)
    params = _scoring_params(args, cfg.dtype)
    new_params, info = distill.distill(params, cfg, n=args.n_test,
                                       steps=args.steps)
    checkpoint.save(args.out, {"params": ansatz.to_numpy_params(new_params)},
                    meta={"fit_rms": info["fit_rms"]})
    print(json.dumps({"out": args.out,
                      "fit_rms_mHa": round(1e3 * info["fit_rms"], 4)}))


def _evaluate_cfg(args):
    """Config and oracle state of ``evaluate``: a .npz checkpoint's meta
    (target_state, m_abs, xi_span, r_lo/r_hi) fills what the flags leave
    open, and the state fixes the envelope parity."""
    from .analysis.exact import STATE_INDEX
    from .io import checkpoint
    cfg = _build_cfg(args)
    state = args.target_state
    if args.checkpoint.endswith(".npz"):
        meta = checkpoint.load_meta(args.checkpoint)
        if state is None:
            state = meta.get("target_state")
        if not cfg.model.m_abs and meta.get("m_abs"):
            cfg = cfg.replace(model=dataclasses.replace(
                cfg.model, arch="separable", m_abs=int(meta["m_abs"])))
        if args.xi_span is None and meta.get("xi_span"):
            # score on the checkpoint's own quadrature box
            cfg = cfg.replace(domain=dataclasses.replace(
                cfg.domain, xi_span=float(meta["xi_span"])))
        if args.dom_r_lo is None and args.dom_r_hi is None \
                and meta.get("r_hi"):
            # extended-well artifacts re-score on their own R domain
            cfg = cfg.replace(domain=dataclasses.replace(
                cfg.domain, r_lo=float(meta.get("r_lo", 0.2)),
                r_hi=float(meta["r_hi"])))
    if state is None:
        if cfg.model.m_abs:
            state = {(1, 1): "2ppu", (1, -1): "3dpg", (2, 1): "3ddg",
                     (3, 1): "4fpu"}[
                (cfg.model.m_abs, cfg.model.inversion_symmetry)]
        else:
            state = "2psu" if cfg.model.inversion_symmetry < 0 else "1ssg"
    # the scored state implies its envelope parity (for m > 0 the total
    # parity is envelope * (-1)^m): derive it rather than trust --state
    env_parity = STATE_INDEX[state][1] if state in STATE_INDEX else None
    if env_parity is not None and cfg.model.inversion_symmetry != env_parity:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, inversion_symmetry=env_parity))
    return cfg, state


def cmd_evaluate(args) -> None:
    """Score a checkpoint: distill the E head onto the Rayleigh quotients of
    psi, tabulate E(R) as a spline, extract the spheroidal E(R) surface and
    report errors against the exact energies. Wall seconds of each part go
    to stderr."""
    from .analysis import energy as aen
    from .analysis import etab
    from .io import checkpoint
    from .models import ansatz
    from .training import distill
    if args.contam_vs:
        raise SystemExit("--contam-vs needs deflation, not ported yet "
                         "(ROADMAP Queue 1, excited-state families)")
    cfg, state = _evaluate_cfg(args)
    params = _scoring_params(args, cfg.dtype)
    new_params, info = distill.distill(params, cfg, n=args.n_test,
                                       steps=args.steps)
    wall = dict(info["seconds"])
    out_dir = args.out or os.path.dirname(os.path.abspath(args.checkpoint))
    os.makedirs(out_dir, exist_ok=True)
    tree = {"params": ansatz.to_numpy_params(new_params)}
    table = None
    t0 = time.perf_counter()
    if args.table_knots:
        table = etab.build_table(new_params, cfg, n_knots=args.table_knots)
        tree["e_table"] = table
    wall["table"] = time.perf_counter() - t0
    eval_meta = {"fit_rms": info["fit_rms"],
                 "table_knots": args.table_knots,
                 "target_state": state}
    if cfg.model.m_abs:
        eval_meta["m_abs"] = cfg.model.m_abs
    if cfg.domain.xi_span != 20.0:
        eval_meta["xi_span"] = cfg.domain.xi_span
    if (cfg.domain.r_lo, cfg.domain.r_hi) != (0.2, 4.0):
        eval_meta["r_lo"] = cfg.domain.r_lo
        eval_meta["r_hi"] = cfg.domain.r_hi
    checkpoint.save(os.path.join(out_dir, "evaluated.npz"), tree,
                    meta=eval_meta)
    t0 = time.perf_counter()
    surf = aen.surface(new_params, cfg, n=args.n_test, lcao=False,
                       grid="spheroidal")
    wall["surface"] = time.perf_counter() - t0
    aen.save_surface(os.path.join(out_dir, "energy_eval.pkl"), surf)
    t0 = time.perf_counter()
    oracle = args.oracle
    if state != "1ssg":
        # only the ODE oracle covers the other states
        exact = aen.exact_energy_ode(surf["R"], state=state)
        oracle = f"ode:{state}"
    else:
        exact = aen.exact_energy(surf["R"], oracle=args.oracle)
    err = 1e3 * np.abs(surf["E_net"] - exact)
    err_int = 1e3 * (surf["E_int"] - exact)   # signed: must be >= 0
    sel = surf["R"] >= 0.5
    out = {
        "checkpoint": args.checkpoint,
        "oracle": oracle,
        "fit_rms_mHa": round(1e3 * info["fit_rms"], 3),
        "mean_err_mHa": round(float(err.mean()), 3),
        "max_err_mHa": round(float(err.max()), 3),
        "mean_err_mHa_R>=0.5": round(float(err[sel].mean()), 3),
        "max_err_mHa_R>=0.5": round(float(err[sel].max()), 3),
        "err_R=0.2": round(float(err[0]), 3),
        # the quadrature Rayleigh quotient of psi, signed: positive at
        # every R certifies a true upper bound
        "int_mean_err_mHa": round(float(np.abs(err_int).mean()), 4),
        "int_max_err_mHa": round(float(np.abs(err_int).max()), 4),
        "int_min_signed_mHa": round(float(err_int.min()), 4),
    }
    if table is not None:
        # the spline table scored as E_net on the surface's R and at the
        # local knot-interval midpoints (interpolation, not lookup)
        e_tab = etab.energy_from_table(table, surf["R"])
        terr = 1e3 * np.abs(e_tab - exact)
        tab_r = np.asarray(table["R"], np.float64)
        mid = 0.5 * (tab_r[:-1] + tab_r[1:])
        mid = mid[(mid >= surf["R"].min()) & (mid <= surf["R"].max())]
        # subsample to bound the oracle cost (~1 s per uncached root)
        r_off = mid[np.unique(np.linspace(0, len(mid) - 1, 48).astype(int))]
        ex_off = aen.exact_energy_ode(r_off, state=state)
        terr_off = 1e3 * np.abs(etab.energy_from_table(table, r_off) - ex_off)
        out.update({
            "tab_mean_err_mHa": round(float(terr.mean()), 4),
            "tab_max_err_mHa": round(float(terr.max()), 4),
            "tab_offknot_mean_err_mHa": round(float(terr_off.mean()), 4),
            "tab_offknot_max_err_mHa": round(float(terr_off.max()), 4),
        })
    wall["oracle"] = time.perf_counter() - t0
    print("evaluate wall seconds: " + json.dumps(
        {k: round(v, 3) for k, v in wall.items()}), file=sys.stderr)
    print(json.dumps(out))


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


def _add_scoring(p):
    """The flags of the scoring subcommands (energy, distill, evaluate)."""
    p.add_argument("checkpoint", help=".npz or the reference's .pt")
    p.add_argument("--device", default="cuda",
                   help="cuda (the Hopper kernels; raises without CUDA) or "
                        "cpu (the plain PyTorch path)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--state", default="gerade",
                   choices=["gerade", "ungerade"],
                   help="envelope inversion parity")
    p.add_argument("--m-abs", type=int, default=0, dest="m_abs",
                   help="|m| of the target sector (separable family; not "
                        "ported yet)")
    p.add_argument("--r-lo", type=float, dest="dom_r_lo")
    p.add_argument("--r-hi", type=float, dest="dom_r_hi")
    p.add_argument("--xi-span", type=float, dest="xi_span",
                   help="prolate-spheroidal quadrature extent (default 20)")
    p.add_argument("--n-test", type=int, default=80, dest="n_test",
                   help="Cartesian quadrature nodes per axis")


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

    p = sub.add_parser("energy", help="E(R) surface extraction")
    _add_scoring(p)
    p.add_argument("--out", default="energy_R_ion.pkl")
    p.add_argument("--no-lcao", action="store_true", dest="no_lcao")
    p.add_argument("--grid", default="uniform",
                   choices=["uniform", "adapted", "spheroidal"],
                   help="adapted = nucleus-clustered Cartesian nodes; "
                        "spheroidal = prolate-spheroidal Gauss quadrature")
    p.add_argument("--oracle", default="wind", choices=["wind", "ode"],
                   help="error ruler: the 4-decimal Wind table or the exact "
                        "ODE solver")
    p.add_argument("--figure", help="surface figure (not ported yet)")
    p.set_defaults(fn=cmd_energy)

    p = sub.add_parser("distill",
                       help="fit the E(R) head to the Rayleigh quotient")
    _add_scoring(p)
    p.add_argument("--out", default="runs/distill/distilled.npz")
    p.add_argument("--steps", type=int, default=5000,
                   help="Adam steps before the 8000 L-BFGS steps")
    p.set_defaults(fn=cmd_distill)

    from .analysis.exact import STATES
    p = sub.add_parser("evaluate",
                       help="distill + spline table + spheroidal surface + "
                            "error report")
    _add_scoring(p)
    p.add_argument("--out", help="output directory (default: the "
                                 "checkpoint's)")
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--oracle", default="ode", choices=["wind", "ode"])
    p.add_argument("--table-knots", type=int, default=153, dest="table_knots",
                   help="knots of the exported spline E(R) table (0: none)")
    p.add_argument("--contam-vs", metavar="CKPT", action="append",
                   dest="contam_vs",
                   help="contamination certificate (needs deflation; not "
                        "ported yet)")
    p.add_argument("--target-state", dest="target_state",
                   choices=list(STATES),
                   help="exact-oracle state to score against (default: the "
                        "checkpoint's meta, else from --state)")
    p.set_defaults(fn=cmd_evaluate)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
