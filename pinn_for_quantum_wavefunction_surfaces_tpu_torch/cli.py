"""Command-line interface of the PyTorch port.

    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli train \\
        --out runs/flagship --epochs 20000 --gz --trainable-exponent \\
        --lr-schedule step
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli finetune \\
        runs/flagship/best.npz --out runs/ft --dtype float64
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli variational \\
        --arch separable --spheroidal --adam-warmup 1500 --lbfgs 800 \\
        --n-r 39 --n-xi 40 --n-eta 24 --dtype float64
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli variational \\
        artifacts/flagship.npz --n-r 32 --n-pts 32768 --antithetic \\
        --stratified-r --epochs 2000
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli energy \\
        runs/ft/finetune.npz --out energy_R_ion.pkl
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli evaluate \\
        artifacts/flagship_separable.npz --steps 8000 --dtype float64
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli analyze \\
        artifacts/flagship_separable.npz --paper-set --dtype float64
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli vibrations \\
        artifacts/evaluated.npz --j-max 5
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli export \\
        artifacts/flagship.npz model.bin
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli sweep \\
        --r-values 0.5 1 2 4 --polish 300 --arch separable --dtype float64
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli train \\
        --mesh 2 --device cpu --epochs 100 --n-train 2048
    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli bench

``train`` and ``finetune`` run the residual PINN trainer of every family
(``--arch symmetric|minimal|separable``, ``--r-input``; stage 1, then the
E-head fine-tune); ``variational`` runs the spheroidal polish
(``--spheroidal``: Adam warmup, then L-BFGS with best-iterate selection on
a third grid, for excited states with node factors, the |m| transverse
factor and deflation against frozen references, ``--deflate``), full-batch
L-BFGS on one importance sample (``--lbfgs N``), or the Monte-Carlo Adam
trainer. ``energy`` extracts the E(R) surface of a checkpoint (.npz, the
reference's .pt or model.bin; ``--figure`` draws it), ``distill`` fits the
E head to the Rayleigh quotients of psi, ``evaluate`` distills, tabulates
E(R) as a spline and scores it against the exact oracle, and ``analyze``
draws the analysis figures (gate, psi cuts, forces, loss; ``--paper-set``:
the reference's named figure set). Each runs on the card, or on the CPU
with ``--device cpu``, and writes the JAX package's files (npz checkpoint
layout, meta keys, history and surface pickles, figures, final JSON line).
``vibrations`` solves the nuclear levels on an evaluated artifact's E(R)
table (numpy and scipy), and ``export`` converts checkpoints (.npz, .bin,
.pt; .csv for an E(R) table). ``sweep`` trains one model per R (the
residual family together, or ``--polish`` the per-R spheroidal polish).
``train``, ``finetune``, ``variational --spheroidal`` and ``sweep`` take
``--mesh N``: N ranks, one a device (NCCL on CUDA, gloo on the CPU),
spawned from this one command line (or the ranks of a torchrun job of that
size). ``bench`` prints the bench line: the training step's points/s of
both families on the card, against its measured float32 ceiling (the
module ``bench``). Drawing needs matplotlib. Every subcommand of the JAX
package's CLI is ported.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _checkpoint_arch(args):
    """The family that a .npz checkpoint (``checkpoint`` or ``resume``)
    names in its meta, or None. Written for the minimal family alone
    (``_family_meta``): its params have the reference-parity symmetric
    tree, so they cannot tell it apart."""
    from .io import checkpoint
    path = getattr(args, "checkpoint", None) or getattr(args, "resume", None)
    if not path or not path.endswith(".npz"):
        return None
    return checkpoint.load_meta(path).get("arch")


def _family_meta(cfg) -> dict:
    """The meta key that a checkpoint of the minimal family carries."""
    return {"arch": "minimal"} if cfg.model.arch == "minimal" else {}


def _build_cfg(args):
    """Config from the parsed flags; a flag a subcommand lacks keeps the
    default. The family is ``--arch``, else the checkpoint's meta, else
    separable with ``--m-abs`` (the only family with pi/delta sectors),
    else symmetric. The minimal family starts from ``minimal_config`` (the
    reference's train.py: its domain, schedule and residual convention)."""
    from .config import Config, minimal_config

    def given(*names):
        return {n: getattr(args, n) for n in names
                if getattr(args, n, None) not in (None, False)}

    arch = getattr(args, "arch", None) or _checkpoint_arch(args) or (
        "separable" if getattr(args, "m_abs", 0) else "symmetric")
    base = minimal_config() if arch == "minimal" else Config()
    model = dataclasses.replace(
        base.model, arch=arch,
        inversion_symmetry=1 if args.state == "gerade" else -1,
        **given("hidden", "wide_alpha", "trainable_exponent", "gz",
                "r_input", "m_abs", "xi_node", "eta_node"))
    if getattr(args, "xi_node2", False):
        # a second radial node implies the first
        model = dataclasses.replace(model, xi_node=True, xi_node2=True)
    domain = dataclasses.replace(
        base.domain, **given("fixed_r", "xi_span", "r_cluster", "sampler",
                             "focus_frac", "focus_scale", "focus_floor"))
    for key, val in (("r_lo", args.dom_r_lo), ("r_hi", args.dom_r_hi)):
        if val is not None:
            domain = dataclasses.replace(domain, **{key: val})
    train = dataclasses.replace(
        base.train, **given("n_train", "epochs", "lr", "seed", "lr_schedule",
                            "resample_frac", "sc_step", "sc_decay",
                            "ema_decay", "residual_weight",
                            "scale_invariant", "correction_reg"))
    return dataclasses.replace(base, model=model, domain=domain, train=train,
                               dtype=args.dtype)


def _log(step, metrics):
    # 9 significant digits: polish progress is sub-mHa on an O(1) Ha
    # objective
    print(f"{step:8d}: " + " ".join(f"{k}={v:.9e}" for k, v in
                                    metrics.items()), flush=True)


# the known states of each (|m|, envelope parity) sector, lowest first: k
# deflated references target the (k+1)-th. Past a same-sector crossing the
# count is not an energy order (4psu/4fsu at R = 1.933), and --target-state
# overrides it
SECTOR_STATES = {(0, 1): ["1ssg", "2ssg", "3dsg", "3ssg"],
                 (0, -1): ["2psu", "3psu", "4psu", "4fsu"],
                 (1, 1): ["2ppu", "3ppu", "4fpiu", "4ppu"],
                 (1, -1): ["3dpg", "4dpg"],
                 (2, 1): ["3ddg", "4ddg"], (2, -1): ["4fdu"],
                 (3, 1): ["4fpu"]}


def _load_as(path: str, dtype: str) -> dict:
    """A checkpoint's params as host (CPU) tensors of ``dtype``, each leaf
    converted once from its stored type: to bfloat16 as the JAX CLI's
    ``np.asarray(a, ml_dtypes.bfloat16)`` (through float32, so the same
    bits)."""
    from .models import ansatz
    return ansatz.from_jax_params(_load_params(path), dtype=dtype,
                                  device="cpu")


def _scoring_dtype(cfg):
    """The type ``energy`` and ``analyze`` score in, the JAX CLI's: the
    checkpoint's own under ``--dtype float64`` (JAX with x64), float32 under
    any other (JAX without x64, which casts nothing)."""
    return None if cfg.dtype == "float64" else "float32"


def _check_variational(args) -> None:
    """Exits on flags that do not go together, before any rank starts."""
    if args.spheroidal and not (args.lbfgs or args.adam_warmup):
        raise SystemExit("--spheroidal is the deterministic objective: give "
                         "it an optimisation budget (--lbfgs N and/or "
                         "--adam-warmup N)")
    if args.adam_warmup and not args.spheroidal:
        raise SystemExit("--adam-warmup belongs to the --spheroidal polish "
                         "(the MC trainer is already Adam)")
    if args.deflate and not args.spheroidal:
        raise SystemExit("--deflate needs the deterministic objective: add "
                         "--spheroidal (MC deflation is not implemented)")
    if args.mesh and not args.spheroidal:
        raise SystemExit("--mesh shards the --spheroidal polish over R rows; "
                         "the Monte-Carlo trainer and --lbfgs on one "
                         "importance sample run on one device: drop --mesh")
    if args.mesh and args.fixed_r is not None:
        # one R: nothing to shard along the R axis
        raise SystemExit("--mesh shards the polish over R rows; with "
                         "--fixed-r there is only one R: drop --mesh")


def _rank_mesh(args):
    """(mesh, coordinator): this rank's mesh under --mesh (None without),
    and whether this process writes files and prints (rank 0)."""
    mesh = getattr(args, "rank_mesh", None)
    return mesh, mesh is None or mesh.is_coordinator


def cmd_variational(args) -> None:
    """Variational training of a checkpoint or of the seeded init: the
    spheroidal polish (``--spheroidal``; deflated against ``--deflate``
    references when given; sharded over R rows with ``--mesh N``),
    full-batch L-BFGS on one importance sample (``--lbfgs N``), or the
    Monte-Carlo Adam trainer."""
    from .io import checkpoint
    from .models import ansatz
    from .training import variational
    cfg = _build_cfg(args)
    mesh, coordinator = _rank_mesh(args)
    params = None
    if args.checkpoint:
        params = _load_as(args.checkpoint, cfg.dtype)
    if coordinator:
        os.makedirs(args.out, exist_ok=True)
    if not args.spheroidal and not args.lbfgs:
        res = variational.train_variational(
            cfg, params=params, n_r=args.n_r, n_pts=args.n_pts,
            epochs=args.epochs or cfg.train.epochs, lr=args.lr,
            antithetic=args.antithetic, stratified=args.stratified_r,
            log_cb=_log, device=args.device)
        checkpoint.save(os.path.join(args.out, "variational.npz"),
                        {"params": res.ema_params}, meta=_family_meta(cfg))
        checkpoint.save(os.path.join(args.out, "variational_raw.npz"),
                        {"params": res.params}, meta=_family_meta(cfg))
        print(json.dumps({"E_mean_final": float(res.history["Energy"][-1]),
                          "runtime_s": round(res.runtime_s, 2),
                          "points_per_sec": round(res.points_per_sec, 1)}))
        return
    deflate_params = None
    if args.deflate:
        deflate_params = [_load_as(path, cfg.dtype) for path in args.deflate]
    if args.spheroidal:
        polished = variational.polish_spheroidal(
            params, cfg, n_r=args.n_r, n_xi=args.n_xi, n_eta=args.n_eta,
            steps=args.lbfgs, adam_steps=args.adam_warmup,
            warmup_save=os.path.join(args.out, "warmup.npz"),
            best_save=os.path.join(args.out, "best_sofar.npz"),
            mesh=mesh, log_cb=_log, deflate_params=deflate_params,
            memory_size=args.lbfgs_memory, device=args.device)
        polish = "spheroidal-lbfgs" if args.lbfgs else "spheroidal-adam"
    else:
        polished = variational.polish_lbfgs(
            params, cfg, n_r=args.n_r, n_pts=args.n_pts, steps=args.lbfgs,
            log_cb=_log, device=args.device)
        polish = "lbfgs"
    if not coordinator:
        return
    meta = {"polish": polish, **_family_meta(cfg)}
    if cfg.domain.xi_span != 20.0:
        # non-default quadrature extent is part of the objective
        meta["xi_span"] = cfg.domain.xi_span
    if cfg.domain.r_cluster != "uniform":
        meta["r_cluster"] = cfg.domain.r_cluster
    if (cfg.domain.r_lo, cfg.domain.r_hi) != (0.2, 4.0):
        meta["r_lo"] = cfg.domain.r_lo
        meta["r_hi"] = cfg.domain.r_hi
    sector = SECTOR_STATES.get(
        (cfg.model.m_abs, cfg.model.inversion_symmetry), [])
    if cfg.model.m_abs:
        meta["m_abs"] = cfg.model.m_abs
        if not deflate_params and sector:
            # a pi/delta sector's minimum needs no deflation
            meta["target_state"] = sector[0]
    if deflate_params is not None:
        meta["deflated"] = ",".join(os.path.basename(p)
                                    for p in args.deflate)
        if len(deflate_params) < len(sector):
            meta["target_state"] = sector[len(deflate_params)]
    if args.target_state:
        meta["target_state"] = args.target_state
    checkpoint.save(os.path.join(args.out, "variational.npz"),
                    {"params": ansatz.to_numpy_params(polished)}, meta=meta)
    print(json.dumps({"out": args.out, "polish": polish,
                      "lbfgs_steps": args.lbfgs,
                      "adam_warmup_steps": args.adam_warmup,
                      "deflated": deflate_params is not None,
                      "spheroidal": bool(args.spheroidal),
                      "device": args.device}))


def _load_params(path: str) -> dict:
    """The param tree (numpy arrays) of a native .npz, a reference .pt or a
    reference model.bin (.bin: the symmetric tree without alpha/GZ heads;
    ``--arch minimal`` scores it as the minimal family)."""
    from .io import checkpoint, modelbin, torch_pt
    if path.endswith(".pt"):
        return torch_pt.load_reference_checkpoint(path)
    if path.endswith(".bin"):
        return modelbin.load_params(path)
    if not path.endswith(".npz"):
        raise SystemExit("the port reads .npz, .pt and .bin checkpoints")
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
    E_net's error against the exact energies. Scored in the JAX CLI's type
    (``_scoring_dtype``): the checkpoint's own under ``--dtype float64``,
    float32 under ``float32`` and ``bfloat16``."""
    from .analysis import energy as aen
    if args.figure:
        from .analysis import plots
        plots.require_matplotlib()
    cfg = _build_cfg(args)
    params = _scoring_params(args, _scoring_dtype(cfg))
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
    if args.figure:
        print(plots.surface_figure(surf, args.figure))


def cmd_analyze(args) -> None:
    """Figures of a checkpoint: the E head, gate (or GZ b(R)), exponents,
    psi cuts, and with ``--forces`` the force panel, ``--history`` the loss
    figure; ``--paper-set`` the reference's named figure set instead.
    Scored in the JAX CLI's type, as ``energy`` is (``_scoring_dtype``)."""
    from .analysis import plots
    from .utils.metrics import load_history
    plots.require_matplotlib()
    cfg = _build_cfg(args)
    params = _scoring_params(args, _scoring_dtype(cfg))
    outdir = args.out
    if args.paper_set:
        hist = load_history(args.history) if args.history else None
        paths = plots.paper_set(params, cfg, outdir, history=hist,
                                n_test=args.n_test, grid=args.grid,
                                hf_points=args.hf_points)
        print(json.dumps({"figures": paths}))
        return
    paths = [plots.energy_curve_figure(params, cfg,
                                       os.path.join(outdir, "energy.png")),
             plots.gate_figure(params, cfg, os.path.join(outdir, "gate.pdf"))]
    expfig = plots.exponent_figure(params, cfg,
                                   os.path.join(outdir, "exponents.pdf"))
    if expfig:
        paths.append(expfig)
    for ri in args.r_cuts:
        paths.append(plots.psi_cut_figure(
            params, cfg, ri, os.path.join(outdir, f"R{ri:g}.png")))
        paths.append(plots.psi_cut_figure(
            params, cfg, ri, os.path.join(outdir, f"R{ri:g}e.png"), diff=True))
    if args.forces:
        paths.append(plots.forces_figure(
            params, cfg, path=os.path.join(outdir, "forces.pdf")))
    if args.history:
        paths.append(plots.loss_figure(
            load_history(args.history),
            os.path.join(outdir, "loss_figure.jpg")))
    print(json.dumps({"figures": paths}))


def cmd_vibrations(args) -> None:
    """Nuclear (vibrational/rotational) levels on the electronic surface
    (analysis.vibration): from an evaluated artifact's spline E(R) table,
    or from the exact ODE oracle as the ruler (--oracle STATE)."""
    from .analysis import etab, vibration
    from .io import checkpoint
    state = args.vib_state
    if args.oracle:
        table = vibration.oracle_table(args.oracle, r_lo=args.r_lo,
                                       r_hi=args.r_hi)
        source = f"oracle:{args.oracle}"
        state = state or args.oracle
    else:
        if not args.checkpoint:
            raise SystemExit("give an evaluated .npz artifact (with an "
                             "e_table subtree) or --oracle STATE")
        table = etab.load_table(args.checkpoint)
        if table is None:
            raise SystemExit(f"{args.checkpoint} carries no e_table "
                             "subtree — run `cli evaluate` first")
        source = args.checkpoint
        if state is None:
            # an evaluated artifact records the oracle state it scores
            # against: it fixes the dissociation asymptote for D0
            state = checkpoint.load_meta(args.checkpoint).get(
                "target_state", "1ssg")
    if args.j_max is not None:
        # the full E(v, J) rovibrational grid: band origins, B_v, D0
        out = {"source": source}
        out.update(vibration.rovibrational_table(
            table, state, n_v=args.n_levels, j_max=args.j_max))
        if args.vib_out:
            with open(args.vib_out, "w") as fh:
                json.dump(out, fh, indent=1)
        print(json.dumps(out))
        return
    levels = vibration.levels_from_table(table, n_levels=args.n_levels,
                                         j=args.j)
    out = {"source": source, "J": args.j, "state": state}
    out.update(vibration.summarize(
        levels, asymptote=vibration.dissociation_asymptote(state)))
    print(json.dumps(out))


def cmd_export(args) -> None:
    """Convert a checkpoint (.npz, .pt, .bin) into .npz, .bin or .pt, or an
    evaluated artifact's E(R) table into .csv. The arrays are written as
    stored: nothing is cast."""
    from .io import checkpoint, modelbin, torch_pt
    if args.output.endswith(".csv"):
        # R,E_electronic,E_total rows of the spline knots (cli evaluate)
        from .analysis import etab
        table = etab.load_table(args.input)
        if table is None:
            raise SystemExit(f"{args.input} carries no e_table subtree — "
                             "run `cli evaluate` first (--table-knots)")
        with open(args.output, "w") as f:
            f.write("R,E_electronic,E_total\n")
            for r, e in zip(table["R"], table["E"]):
                f.write(f"{r:.12g},{e:.15g},{e + 0.5 / r:.15g}\n")
        print(json.dumps({"written": args.output,
                          "knots": len(table["R"])}))
        return
    params = _load_params(args.input)
    if args.output.endswith((".bin", ".pt")):
        missing = sorted({"h1", "h2", "out", "e1", "e2", "eout", "gate1",
                          "gate2"} - set(params))
        if missing:
            raise SystemExit(f"{os.path.splitext(args.output)[1]} holds "
                             "the reference-parity symmetric tree; "
                             f"{args.input} lacks its layers {missing}")
    if args.output.endswith(".bin"):
        modelbin.save_params(args.output, params)
    elif args.output.endswith(".pt"):
        torch_pt.save_reference_checkpoint(args.output, params)
    else:
        checkpoint.save(args.output, {"params": params}, meta={})
    print(json.dumps({"written": args.output}))


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
                    meta={"fit_rms": info["fit_rms"], **_family_meta(cfg)})
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
        # the lowest state of the sector
        state = SECTOR_STATES[(cfg.model.m_abs,
                               cfg.model.inversion_symmetry)][0]
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
    from .training import distill, variational
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
                 "target_state": state, **_family_meta(cfg)}
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
    if args.contam_vs:
        # the excited-state certificate: psi's norm fraction inside the
        # span of the lower states, on a grid independent of training's
        t_contam = time.perf_counter()
        refs = [_load_as(p, cfg.dtype) for p in args.contam_vs]
        frac = variational.contamination_curve(new_params, refs, cfg,
                                               surf["R"])
        out["contam_max_frac"] = float(frac.max())
        out["contam_mean_frac"] = float(frac.mean())
        wall["contam"] = time.perf_counter() - t_contam
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
    wall["oracle"] = time.perf_counter() - t0 - wall.get("contam", 0.0)
    print("evaluate wall seconds: " + json.dumps(
        {k: round(v, 3) for k, v in wall.items()}), file=sys.stderr)
    print(json.dumps(out))


def cmd_train(args) -> None:
    """Stage-1 residual training (the paper schedule by default; the batch
    sharded over the ranks with ``--mesh N``)."""
    from .io import checkpoint
    from .training import engine
    from .utils.metrics import MetricLogger, save_history
    cfg = _build_cfg(args)
    mesh, coordinator = _rank_mesh(args)
    log = None
    if coordinator:
        os.makedirs(args.out, exist_ok=True)
        log = MetricLogger(os.path.join(args.out, "metrics.jsonl"))

    def ckpt_cb(state, step):
        checkpoint.save(os.path.join(args.out, "best.npz"),
                        {"params": state.best_params},
                        meta={"step": step,
                              "best_loss": float(state.best_loss),
                              **_family_meta(cfg)})
        # full training state (params + Adam moments) for exact resume, in
        # the JAX package's keys (opt/0/count, opt/0/mu/..., opt/1/count)
        checkpoint.save(os.path.join(args.out, "state.npz"),
                        {"params": state.params, "opt": state.opt_state},
                        meta={"step": step, **_family_meta(cfg)})

    params = opt_state = None
    start_step = 0
    if args.resume:
        if args.resume.endswith("state.npz"):
            tree, meta = checkpoint.load_params(args.resume)
            params, opt_state = tree["params"], tree["opt"]
            start_step = int(meta.get("step", 0))
        else:
            params = _load_params(args.resume)
    with contextlib.ExitStack() as stack:
        if args.profile and coordinator:
            from .utils.profiling import trace
            stack.enter_context(trace(args.profile))
        res = engine.train(cfg, params=params, opt_state=opt_state,
                           start_step=start_step, log_cb=log,
                           checkpoint_cb=ckpt_cb, mesh=mesh,
                           device=args.device)
    if not coordinator:
        return
    log.close()
    checkpoint.save(os.path.join(args.out, "final.npz"),
                    {"params": res.params},
                    meta={"best_loss": res.best_loss,
                          "runtime_s": res.runtime_s, **_family_meta(cfg)})
    checkpoint.save(os.path.join(args.out, "best.npz"),
                    {"params": res.best_params},
                    meta={"best_loss": res.best_loss, **_family_meta(cfg)})
    if cfg.train.ema_decay > 0:
        checkpoint.save(os.path.join(args.out, "ema.npz"),
                        {"params": res.ema_params}, meta=_family_meta(cfg))
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
    cfg = finetune_config(_build_cfg(args))
    if args.epochs:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, epochs=args.epochs))
    mesh, coordinator = _rank_mesh(args)
    params = _load_params(args.checkpoint)
    res = engine.finetune(cfg, params=params, log_cb=_log, mesh=mesh,
                          device=args.device)
    if not coordinator:
        return
    os.makedirs(args.out, exist_ok=True)
    checkpoint.save(os.path.join(args.out, "finetune.npz"),
                    {"params": res.best_params},
                    meta={"best_loss": res.best_loss, **_family_meta(cfg)})
    save_history(os.path.join(args.out, "history_finetune.pkl"), res.history)
    print(json.dumps({"best_loss": res.best_loss}))


def _check_sweep(args) -> None:
    if args.polish and args.mesh:
        raise SystemExit("--polish runs per-R single-row quotients and does "
                         "not shard over a mesh; drop --mesh")


def cmd_sweep(args) -> None:
    """Per-R multi-model family: the residual family trained together (the
    models split over the ranks with ``--mesh N``), or with ``--polish N``
    the per-R deterministic spheroidal polish. Writes the JAX CLI's pickle
    (R, E_net, best_loss) and JSON line."""
    import pickle
    from .training import sweep
    cfg = _build_cfg(args)
    mesh, coordinator = _rank_mesh(args)
    rs = args.r_values or list(np.round(np.arange(
        cfg.domain.r_lo, cfg.domain.r_hi + 1e-9, args.r_step), 2))
    if args.polish:
        out = sweep.polish_per_r(cfg, rs, steps=args.polish,
                                 device=args.device)
    else:
        out = sweep.train_per_r_vmapped(cfg, rs, mesh=mesh,
                                        device=args.device)
    if not coordinator:
        return
    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".",
                exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump({"R": out["R"], "E_net": out["E_net"],
                     "best_loss": out["best_loss"]}, f)
    print(json.dumps({"out": args.out,
                      "R": list(map(float, out["R"])),
                      "E_net": [round(float(e), 6) for e in out["E_net"]]}))


def cmd_bench(args) -> None:
    """The bench line (one JSON line; module ``bench``)."""
    from . import bench
    bench.run(args)


def _add_common(p):
    p.add_argument("--device", default="cuda",
                   help="cuda (the Hopper kernels; raises without CUDA) or "
                        "cpu (the plain PyTorch path)")
    _add_dtype(p)
    p.add_argument("--arch", choices=["symmetric", "minimal", "separable"],
                   help="model family (default: the checkpoint's meta, "
                        "else symmetric)")
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
    _add_dtype(p)
    p.add_argument("--state", default="gerade",
                   choices=["gerade", "ungerade"],
                   help="envelope inversion parity")
    p.add_argument("--m-abs", type=int, default=0, dest="m_abs",
                   help="|m| of the target sector (separable family)")
    p.add_argument("--arch", choices=["symmetric", "minimal", "separable"],
                   help="family of the checkpoint's psi, which the params "
                        "tell apart but for minimal: a .npz of the minimal "
                        "family names it in its meta, a model.bin holds "
                        "the symmetric tree and scores as the "
                        "reference-parity model unless --arch minimal "
                        "(default: the meta's, else separable with "
                        "--m-abs, else symmetric)")
    p.add_argument("--r-lo", type=float, dest="dom_r_lo")
    p.add_argument("--r-hi", type=float, dest="dom_r_hi")
    p.add_argument("--xi-span", type=float, dest="xi_span",
                   help="prolate-spheroidal quadrature extent (default 20)")
    _add_r_cluster(p)
    p.add_argument("--n-test", type=int, default=80, dest="n_test",
                   help="Cartesian quadrature nodes per axis")


def _add_dtype(p):
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"],
                   help="compute type (bfloat16: the kernels' bfloat16 "
                        "builds on the card)")


def _add_r_cluster(p):
    p.add_argument("--r-cluster", dest="r_cluster",
                   choices=["uniform", "log"],
                   help="R-row layout of the variational objective: 'log' "
                        "clusters the rows toward the united-atom end")


def _add_residual(p):
    """The flags of the residual trainer (train, finetune)."""
    _add_common(p)
    p.add_argument("--epochs", type=int,
                   help="TOTAL schedule length; a resumed run trains the "
                        "remaining epochs - start_step steps")
    p.add_argument("--lr", type=float)
    _add_schedule(p)
    _add_residual_data(p)
    _add_symmetric_model(p)
    _add_sector(p)
    _add_mesh(p, "shard the collocation batch over N devices")


def _add_residual_data(p):
    """The residual trainer's batch, sampler and loss flags. ``variational``
    takes them too, as the JAX CLI's does: they set the same Config fields,
    of which its objectives read only the Monte-Carlo draws' focus_frac and
    focus_scale."""
    p.add_argument("--n-train", type=int, dest="n_train")
    p.add_argument("--sampler", choices=["uniform", "mixed"],
                   help="mixed = nucleus-focused importance sampling")
    p.add_argument("--focus-frac", type=float, dest="focus_frac")
    p.add_argument("--focus-scale", type=float, dest="focus_scale")
    p.add_argument("--focus-floor", type=float, dest="focus_floor")
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
    p.add_argument("--resample-frac", type=float, dest="resample_frac")


def _add_sector(p):
    """The flags of the target sector and its quadrature (the JAX CLI's,
    with its defaults)."""
    p.add_argument("--m-abs", type=int, default=0, dest="m_abs",
                   help="|m| of the target sector: the separable ansatz "
                        "gains the harmonic transverse factor Re[(y + i "
                        "z)^m] (pi: 1, delta: 2, phi: 3)")
    p.add_argument("--wide-alpha", action="store_true", dest="wide_alpha",
                   help="orbital exponent alpha(R) in (0.3, 2.25) instead "
                        "of (0.75, 2.25) (separable family)")
    p.add_argument("--xi-span", type=float, dest="xi_span",
                   help="prolate-spheroidal quadrature extent in bohr "
                        "(default 20)")
    _add_r_cluster(p)


def _add_mesh(p, what: str):
    p.add_argument("--mesh", type=int, default=0,
                   help=f"{what} (0: off): one rank a device, NCCL on CUDA "
                        "(cuda:0..N-1), gloo on the CPU; raises when the "
                        "host has fewer devices")


def _add_symmetric_model(p):
    """The model flags of the symmetric and minimal families (the GZ and
    alpha heads also belong to the separable family, which always has
    them)."""
    p.add_argument("--trainable-exponent", action="store_true",
                   dest="trainable_exponent",
                   help="learn the orbital exponent alpha(R)")
    p.add_argument("--r-input", action="store_true", dest="r_input",
                   help="feed R/4 into the correction MLP (symmetric and "
                        "minimal families; no kernel carries it: the plain "
                        "forward-Laplacian path)")
    p.add_argument("--gz", action="store_true",
                   help="Guillemin-Zener physics part e^{-a r1 - b r2} "
                        "with trainable b(R) (LCAO is b=0)")


def _add_schedule(p):
    p.add_argument("--lr-schedule", choices=["none", "step"],
                   dest="lr_schedule",
                   help="step = exponential decay (sc_step/sc_decay)")
    p.add_argument("--sc-step", type=int, dest="sc_step")
    p.add_argument("--sc-decay", type=float, dest="sc_decay")


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
    p.add_argument("--profile", metavar="DIR",
                   help="capture a torch.profiler trace of the run into "
                        "DIR/trace.json (Chrome trace; view in Perfetto)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("finetune", help="stage-2 E-head fine-tune")
    _add_residual(p)
    p.add_argument("checkpoint")
    p.add_argument("--out", default="runs/stage2")
    p.set_defaults(fn=cmd_finetune)

    p = sub.add_parser(
        "variational", help="Rayleigh-quotient (variational) training",
        description="Without --spheroidal and --lbfgs: the Monte-Carlo Adam "
                    "trainer, n_r x n_pts importance-sampled points a step "
                    "(1 048 576 at the defaults); it writes the EMA "
                    "(variational.npz) and the last params "
                    "(variational_raw.npz). Separable and 2-input "
                    "symmetric models run through the kernels; minimal and "
                    "R-input models through the plain forward-Laplacian "
                    "path, whose autograd keeps (points, 3, H) tensors: "
                    "several times the device memory at the defaults, "
                    "which one 80 GB card holds (PERF.md, section 5).")
    p.add_argument("checkpoint", nargs="?",
                   help="warm-start checkpoint (default: the seeded init)")
    p.add_argument("--out", default="runs/variational")
    _add_common(p)
    _add_symmetric_model(p)
    _add_schedule(p)
    _add_residual_data(p)
    p.add_argument("--n-pts", type=int, default=32768, dest="n_pts",
                   help="importance samples per R row (Monte-Carlo trainer "
                        "and --lbfgs without --spheroidal)")
    p.add_argument("--epochs", type=int,
                   help="Monte-Carlo trainer steps (default 5000; 1000 with "
                        "--arch minimal)")
    p.add_argument("--lr", type=float,
                   help="Monte-Carlo trainer rate (default 8e-3, the rate "
                        "of a run from the init)")
    p.add_argument("--antithetic", action="store_true",
                   help="antithetic radial pairs in the shells' draws")
    p.add_argument("--stratified-r", action="store_true", dest="stratified_r",
                   help="one R draw per stratum of the R range per step")
    _add_sector(p)
    _add_mesh(p, "shard the --spheroidal polish's R rows over N devices")
    p.add_argument("--spheroidal", action="store_true",
                   help="deterministic objective: exact per-R quotients on "
                        "prolate-spheroidal Gauss grids")
    p.add_argument("--n-r", type=int, default=32, dest="n_r")
    p.add_argument("--n-xi", type=int, default=48, dest="n_xi")
    p.add_argument("--n-eta", type=int, default=48, dest="n_eta")
    p.add_argument("--adam-warmup", type=int, default=0, dest="adam_warmup",
                   help="deterministic-Adam steps before the L-BFGS polish")
    p.add_argument("--lbfgs", type=int, default=0,
                   help="L-BFGS steps: of the polish with --spheroidal, "
                        "else full-batch on one importance sample")
    p.add_argument("--lbfgs-memory", type=int, default=15,
                   dest="lbfgs_memory", help="L-BFGS curvature-memory size")
    p.add_argument("--xi-node", action="store_true", dest="xi_node",
                   help="trainable radial node factor (radially excited "
                        "states: 2s sigma_g, 3p sigma_u)")
    p.add_argument("--xi-node2", action="store_true", dest="xi_node2",
                   help="second radial node factor (implies --xi-node): "
                        "doubly radially excited states (3s sigma_g)")
    p.add_argument("--eta-node", action="store_true", dest="eta_node",
                   help="trainable angular node factor (3d sigma_g)")
    p.add_argument("--deflate", metavar="CKPT", action="append",
                   help="frozen reference-state checkpoint of the same "
                        "sector: minimise the deflated quotient, targeting "
                        "the sector's next state up; repeat to deflate k "
                        "states and target the (k+1)-th")
    p.add_argument("--target-state", dest="target_state",
                   help="the oracle state recorded in the checkpoint's "
                        "meta, instead of the count of --deflate "
                        "references (needed past same-sector crossings)")
    p.set_defaults(fn=cmd_variational, check=_check_variational)

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
    p.add_argument("--figure", help="also write the surface figure here "
                                    "(needs matplotlib)")
    p.set_defaults(fn=cmd_energy)

    p = sub.add_parser("analyze", help="figures: gate, psi cuts, forces "
                                       "(needs matplotlib)")
    _add_scoring(p)
    p.add_argument("--out", default="figures")
    p.add_argument("--r-cuts", type=float, nargs="*", default=[1.0, 2.0],
                   dest="r_cuts")
    p.add_argument("--forces", action="store_true")
    p.add_argument("--history", help="history.pkl for the loss figure")
    p.add_argument("--paper-set", action="store_true", dest="paper_set",
                   help="emit the reference's exact named figure set "
                        "(fig2/3/4.pdf, fig_R1/2/3.pdf, loss_figure.pdf, "
                        "energy.png, R{1,2}{,e}.png)")
    p.add_argument("--grid", default="spheroidal",
                   choices=["uniform", "adapted", "spheroidal"],
                   help="quadrature grid of the paper set's surface")
    p.add_argument("--hf-points", type=int, default=9, dest="hf_points",
                   help="Hellmann-Feynman sample count in the force panel")
    p.set_defaults(fn=cmd_analyze)

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
                   help="report the norm fraction of psi inside the span "
                        "of these frozen lower-state checkpoints (the "
                        "excited-state certificate; repeatable)")
    p.add_argument("--target-state", dest="target_state",
                   choices=list(STATES),
                   help="exact-oracle state to score against (default: the "
                        "checkpoint's meta, else from --state)")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("sweep", help="per-R multi-model family (legacy "
                                     "mode)")
    _add_residual(p)
    p.add_argument("--r-values", type=float, nargs="*", dest="r_values")
    p.add_argument("--r-step", type=float, default=0.5, dest="r_step")
    p.add_argument("--out", default="runs/sweep/energy_sweep.pkl")
    p.add_argument("--polish", type=int, default=0,
                   help="per-R deterministic spheroidal L-BFGS polish with "
                        "this many steps instead of residual training")
    p.set_defaults(fn=cmd_sweep, check=_check_sweep)

    p = sub.add_parser("export", help="convert checkpoint formats")
    p.add_argument("input", help=".npz | .pt | .bin")
    p.add_argument("output", help=".npz | .bin | .pt, or .csv for an "
                                  "evaluated artifact's E(R) table")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("vibrations",
                       help="nuclear vibrational/rotational levels on the "
                            "tabulated E(R) surface (BO spectroscopy)")
    p.add_argument("checkpoint", nargs="?",
                   help="evaluated .npz artifact carrying an e_table")
    p.add_argument("--oracle", metavar="STATE",
                   help="use the exact ODE oracle's curve instead "
                        "(e.g. 1ssg): the exact-BO ruler")
    p.add_argument("--n-levels", type=int, default=4, dest="n_levels")
    p.add_argument("--j", type=int, default=0,
                   help="rotational quantum number J")
    p.add_argument("--j-max", type=int, default=None, dest="j_max",
                   help="emit the full E(v<=n_levels-1, J<=j_max) "
                        "rovibrational grid (band origins, B_v, D0) "
                        "instead of one J ladder")
    p.add_argument("--out", dest="vib_out",
                   help="with --j-max: also write the grid as JSON here")
    p.add_argument("--state", dest="vib_state",
                   help="electronic state label for the dissociation "
                        "asymptote (default: the artifact's target_state "
                        "meta / the --oracle state)")
    p.add_argument("--r-lo", type=float, default=0.2, dest="r_lo",
                   help="oracle-table R domain lower edge (half distance)")
    p.add_argument("--r-hi", type=float, default=4.0, dest="r_hi",
                   help="oracle-table R domain upper edge (excited wells "
                        "sit near D ~ 8-18: extend past 4 for them)")
    p.set_defaults(fn=cmd_vibrations)

    from . import bench
    p = sub.add_parser("bench", help="throughput microbenchmark: the "
                                     "training step's points/s (one JSON "
                                     "line)")
    bench.add_arguments(p)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    check = getattr(args, "check", None)
    if check is not None:
        check(args)
    if getattr(args, "mesh", 0):
        from .parallel import mesh as pmesh
        pmesh.launch(_on_rank, args.mesh, device=args.device, args=(args,))
    else:
        args.fn(args)


def _on_rank(mesh, args) -> None:
    """The subcommand on one rank of its ``--mesh``."""
    args.rank_mesh = mesh
    args.fn(args)


if __name__ == "__main__":
    main()
