#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught and passed over):
 1. header: the card's name and power limit, torch and CUDA versions;
 2. build: the five CUDA kernels from csrc/ (K1 and K2, forward and
    backward, and K3), one nvcc per source, all in parallel; ptxas
    registers and spills of every instantiation (the backward kernels'
    point-gradient ones marked PG); K1's and K2's shared memory per block
    and resident blocks per SM at every width in both types, PG too;
 K1, the separable-spheroidal variational trainer (make flagship):
 3. kernel check at the flagship training batch (164 502 points of the
    dual spheroidal grid, artifacts/flagship_separable.npz weights), in
    float64 and float32: K1-fwd against the plain forward, K1-bwd against
    autograd of the plain forward under seeded random cotangents, and two
    K1-bwd launches equal bit for bit; the same at 9 216 points (one
    spheroidal quotient of make evaluate), and at that quotient at the
    other widths (H = 4, 8, 32; seeded weights) in float64;
 4. scoring: the flagship's E_int through K1-fwd at R = 0.2, 1, 2, 4 within
    [-1e-4, 0.01] mHa of the exact oracle;
 5. training: the port's polish_spheroidal at the flagship recipe's sizes
    (n_r 39, 40 x 24 dual grid + validation grid, float64) from the seeded
    GZ init, a few dozen Adam then L-BFGS steps; the loss must be finite and
    lower, and both kernels must have launched during this run; launches
    and line-search evaluations per L-BFGS step;
 6. times: CUDA-event times of the kernels and their plain versions at the
    flagship batch, beside the bound;
 7. profile: torch.profiler over ten loss-and-gradient evaluations at the
    flagship batch (device busy share, device time by kernel);
 K2, the residual PINN trainer of the symmetric family (make train):
 8. kernel check at the make-train batch (100 000 points drawn by the
    port's sample_batch from a fixed seed; artifacts/flagship.npz, P = +1,
    and artifacts/ungerade_2psu.npz, P = -1), in float64 and float32: K2-fwd
    against psi_lap_train_plain, K2-bwd against psi_lap_train_vjp_plain
    under seeded cotangents, two K2-bwd launches equal bit for bit; the
    same in float64 at the other widths (H = 4, 8, 32; seeded weights) on a
    9 216-point and a ragged 1 100-point batch, in both sectors;
 9. golden: flagship.npz's E_int through K2-fwd at R = 0.2, 1, 2, 4
    (float64) equal to the JAX package's CPU values to 1e-10 and above the
    exact oracle;
 10. training: engine.train at make train's configuration (GZ + alpha, step
    schedule, float32, 100 000 points, seeded init) for a cut number of
    steps after a warm-up run, then engine.finetune from its best params;
    the loss on a fixed batch must be finite and lower, both K2 kernels
    must have launched in training, and fine-tuning (every K2 input frozen)
    must launch no K2-bwd; steps/s and points/s;
 11. times: CUDA-event times of K2 and its plain versions at 100 000
    points in both types, beside the bound;
 12. profile: torch.profiler over a run of ten training steps and over its
    setup alone (device busy share, device time by kernel);
 K3 and the forward-only scoring layer (cli energy, cli evaluate):
 13. K3 check at the paper widths (H = 16, gate 10; seeded weights whose
    correction is a sizeable share of psi) on the 80^3 grid at R = 1 and on
    1 048 576 uniform points in +-18 at R = 2, P = +1 and -1 (and one case
    with ry, rz != 0), in float64 and float32, against
    psi_lap_residual_plain; then CUDA-event times of both at 512 000 and
    1 048 576 points beside the bound;
 14. K3 golden: E_int and E_lcao of those weights on the uniform n = 80 and
    the spheroidal 96 x 96 grids at R = 0.5, 1, 2, 4 (float64) equal to the
    JAX package's CPU values to 1e-10, every model quotient through K3;
 15. make ref-recipe, cut: cli train (reference-parity model, float64) and
    cli finetune for a few steps (K2 launches, and cli train's steps/s),
    then cli energy on finetune.npz at its defaults (uniform n = 80, 39 R,
    LCAO, Wind oracle) through the port's cli.main: the pickle's schema,
    finite errors, one K3 launch a model quotient; wall time, points/s and
    K3's share of the device time;
 16. make evaluate: cli evaluate artifacts/flagship_separable.npz --steps
    8000 --dtype float64 into a temporary directory: its e_table equal to
    artifacts/evaluated.npz's to 1e-10 at all 153 knots, E_int within
    [-1e-4, 0.01] mHa of the exact oracle, the table within 0.001 mHa, the
    head's fit RMS within 0.01 mHa, one K1-fwd launch a quotient; the wall
    time of each part, and the device the E-head fit ran on;
 The point cotangents of K1-bwd and K2-bwd (point_grads=True):
 17. autograd of sum(psi^2) + sum(lap) in x, y, z, r through
    psi_lap_train_separable(..., point_grads=True) at the flagship batch
    (float64 and float32) and psi_lap_train(..., point_grads=True) at the
    make-train batch (flagship.npz and ungerade_2psu.npz, both types), the
    launches counted; its point gradients against the CPU on a slice; the
    PG kernels against the plain point_grads VJPs (dx..dr, the weights, a,
    b, g) at those sizes and at H = 4, 8, 32 on 1 100 points in both
    sectors, with bitwise repeats; central differences of psi and lap psi
    in x and R at 64 float64 points; CUDA-event times of the PG and the
    training launches side by side, beside the bound.

Each phase prints its wall time. Then one JSON line ``{"kernels": [...]}``,
the card line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA, and when run
from a directory that does not hold the package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "pinn_for_quantum_wavefunction_surfaces_tpu_torch"

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W): 67
# TFLOP/s FP64 (tensor-core rate; 34 outside the tensor cores) and 67 TFLOP/s
# FP32 outside the tensor cores; 3.35 TB/s of HBM3. The larger rates give
# the least time, so the bound below is a true lower bound.
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# dual-grid training batch of the flagship recipe (make flagship)
N_R, N_XI, N_ETA = 39, 40, 24
ADAM_STEPS, LBFGS_STEPS = 40, 30

# make train's batch, and the cut depth of phase 10 (of 20 000 epochs)
N_TRAIN = 100_000
TRAIN_STEPS, FINETUNE_STEPS, WARMUP_STEPS = 300, 100, 20

# E_int of artifacts/flagship.npz (symmetric, GZ + alpha, P = +1) from the
# JAX package on the CPU in float64: analysis.energy.
# rayleigh_quotient_spheroidal on its default 96 x 96 grid, xi_span 20
JAX_EINT_FLAGSHIP = {0.2: -1.8002549328974087, 1.0: -1.1024339738821405,
                     2.0: -0.7958491215620099, 4.0: -0.6272660864051361}


K3_SEED = 2024
# E_int and E_lcao of k3_weights() (P = +1) from the JAX package on the CPU
# in float64: (analysis.energy.rayleigh_quotient on the uniform n = 80 grid,
# the same with which="lcao", rayleigh_quotient_spheroidal on its default
# 96 x 96 grid, the same with which="lcao"); tests/test_torch_scoring.py
# recomputes them
JAX_K3_GOLDEN = {
    0.5: (-1.2686495267025124, -1.2736007503030435, -1.2851256458571025,
          -1.2883662588230806),
    1.0: (-1.0447126940832976, -1.0488791351777813, -1.0514545121396084,
          -1.0537714953184887),
    2.0: (-0.7833962643712423, -0.7862243297246184, -0.7861984584927523,
          -0.7868661240117566),
    4.0: (-0.6224376905639958, -0.6267191215348822, -0.6260078041538885,
          -0.6267294759569224),
}


def k3_weights() -> dict:
    """Reference-parity symmetric params at the paper widths (correction MLP
    2 -> 16 -> 16 -> 1, gate 1 -> 10 -> 1, E head 1 -> 32 -> 32 -> 1) in the
    JAX layout of numpy arrays, drawn from numpy's default_rng(K3_SEED):
    each layer U(+-s/sqrt(fan_in)) as torch.nn.Linear draws with s = 1,
    except s = 4 for the first layer and s = 8 for the correction's output
    layer, so that the correction is a sizeable share of psi. The output
    bias cancels the branches' value far from the nuclei (where both
    envelopes vanish), so the gerade correction decays as psi does."""
    import numpy as np
    rng = np.random.default_rng(K3_SEED)

    def lin(d_in, d_out, s=1.0):
        bound = s / np.sqrt(d_in)
        return {"w": rng.uniform(-bound, bound, (d_in, d_out)),
                "b": rng.uniform(-bound, bound, (d_out,))}

    p = {"h1": lin(2, 16, 4.0), "h2": lin(16, 16), "out": lin(16, 1, 8.0),
         "e1": lin(1, 32), "e2": lin(32, 32), "eout": lin(32, 1),
         "gate1": lin(1, 10), "gate2": lin(10, 1)}

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    far = sig(sig(p["h1"]["b"]) @ p["h2"]["w"] + p["h2"]["b"]) \
        @ p["out"]["w"][:, 0]
    p["out"]["b"] = np.array([-2.0 * far])
    return p


def fwd_ops(h: int) -> int:
    """Floating-point operations of K1-fwd per point (each transcendental
    counted once; csrc/separable_fwd.cu): two MLPs of 6 H^2 + 29 H + 1
    plus geometry, GZ and the bounded correction."""
    return 12 * h * h + 58 * h + 117


def bwd_ops(h: int) -> int:
    """K1-bwd per point, counting only what the VJP needs: the forward
    (fwd_ops), the adjoint of the bounded correction, product rule and GZ
    pair (117), and per MLP the adjoint of its layers (6 H^2 + 54 H: the
    input cotangents of the second layer are 3 H^2 multiply-adds) and the
    weight-gradient sums (6 H^2 + 6 H + 1: dW2 is 3 H^2 multiply-adds).
    The kernel evaluates no layer twice: the forward's tiles stay in shared
    memory for the adjoint (csrc/separable_bwd.cu)."""
    return fwd_ops(h) + 24 * h * h + 120 * h + 119


def train_fwd_ops(h: int) -> int:
    """Floating-point operations of K2-fwd per point (each transcendental
    counted once; csrc/train_fwd.cu): per branch the envelope geometry (43),
    the first layer (29 H) and the second with its output (8 H^2 + 23 H),
    then the mirror, the combination and the Guillemin-Zener pair (43)."""
    return 16 * h * h + 104 * h + 129


def train_bwd_ops(h: int) -> int:
    """K2-bwd per point, counting only what the VJP needs: the forward, and
    per branch the adjoint of the second layer (30 H), its input
    cotangents (8 H^2), the first-layer adjoint (60 H) and the exponent's
    cotangent (30), and the weight-gradient sums (8 H^2 + H); then the
    output-weight and bias sums (4 H + 1), the GZ adjoint and dg (43). The
    kernels evaluate no unit twice (csrc/train_bwd.cu)."""
    return train_fwd_ops(h) + 32 * h * h + 186 * h + 104


def bwd_pg_ops(h: int) -> int:
    """K1-bwd with point gradients (csrc/separable_bwd.cu, PG = true):
    bwd_ops, the MLPs' input cotangents (8 H: a multiply-add for s and for
    R/4 a unit and MLP), and the per-point adjoint of the features, the GZ
    pair, the explicit R and the geometry (172; what the kernel evaluates
    again of the forward is not counted)."""
    return bwd_ops(h) + 8 * h + 172


def train_bwd_pg_ops(h: int) -> int:
    """K2-bwd with point gradients (csrc/train_bwd.cu, PG = true):
    train_bwd_ops, per branch and unit the envelope cotangents and c12's
    (21: 42 H), and per point both branches' envelope and geometry
    adjoints and the GZ pair's (184)."""
    return train_bwd_ops(h) + 42 * h + 184


def residual_fwd_ops(h: int, hg: int) -> int:
    """Floating-point operations of K3 per point (each transcendental
    counted once; csrc/residual_fwd.cu): the two branches as in K2-fwd
    (16 H^2 + 104 H + 86), the gate's units (8 each), and the combination
    with the LCAO part and the gate's bias (15)."""
    return 16 * h * h + 104 * h + 8 * hg + 101


def bound_ms(n: int, h: int, dtype: str, which: str, kernel: str = "K1",
             hg: int = 10):
    """(least time in ms, "bytes" or "operations") of one call: each input
    read once and each output written once at the memory rate, against the
    operations at the peak rate of their type. which: "fwd", "bwd", or
    "bwd_pg" (the backward with point gradients: dx, dy, dz, dr out)."""
    size = 8 if dtype == "float64" else 4
    if kernel == "K3":
        wsize = h * h + 5 * h + 1 + 3 * hg + 1
        nbytes = size * (6 * n + wsize)            # x y z r -> psi lap
        ops = n * residual_fwd_ops(h, hg)
    elif kernel == "K1":
        wsize = 2 * (h * h + 5 * h + 1)
        if which == "fwd":
            nbytes = size * (8 * n + wsize)        # x y z r a b -> psi lap
            ops = n * fwd_ops(h)
        elif which == "bwd":
            nbytes = size * (10 * n + 2 * wsize)   # + dpsi dlap -> da db, dW
            ops = n * bwd_ops(h)
        else:
            nbytes = size * (14 * n + 2 * wsize)   # + dx dy dz dr
            ops = n * bwd_pg_ops(h)
    else:
        wsize = h * h + 5 * h + 1
        if which == "fwd":
            nbytes = size * (9 * n + wsize)        # x y z r a b g -> psi lap
            ops = n * train_fwd_ops(h)
        elif which == "bwd":
            nbytes = size * (12 * n + 2 * wsize)   # + dpsi dlap -> da db dg, dW
            ops = n * train_bwd_ops(h)
        else:
            nbytes = size * (16 * n + 2 * wsize)   # + dx dy dz dr
            ops = n * train_bwd_pg_ops(h)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel instantiation of an nvcc -Xptxas -v log: its
    type and width (PG: a backward kernel's point-gradient instantiation),
    registers, and stack and spill bytes."""
    out, inst, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'.*_kernelI([df])Li(\d+)E(?:Lb([01])E)?", line)
        if m:
            inst = (("float64" if m.group(1) == "d" else "float32"),
                    int(m.group(2)), " PG" if m.group(3) == "1" else "")
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and inst:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{inst[0]} H={inst[1]}{inst[2]}: {regs} registers; "
                       f"{spill}")
            inst = None
    return out


_PHASE_START = [None]


def phase(name: str | None = None):
    """Print the wall time of the phase that ends here and the header of
    the next one (none at the end)."""
    now = time.time()
    if _PHASE_START[0] is not None:
        print(f"   (phase wall time {now - _PHASE_START[0]:.1f} s)",
              flush=True)
    _PHASE_START[0] = now
    if name:
        print(f"== {name}", flush=True)


# cycles per second assumed for the spin kernel: above the H100's 1.98 GHz
# boost clock, so a spin lasts at least as long as it is asked to
SPIN_HZ = 2e9


def cuda_ms(fn, reps: int = 20, warmup: int = 3, label: str = "") -> float:
    """Device time per call: CUDA events around ``reps`` back-to-back calls.
    A spin kernel holds the stream while the host enqueues them (twice the
    host time the warm-up calls took), so the events time the device's work
    and not the host's launch rate: one call of a wrapper costs more host
    time than the forward kernel takes. The calls must fit the device's
    queue of pending launches (about a thousand), or the host blocks until
    the spin ends: the plain versions launch a hundred or more small kernels
    a call, so they are timed over one or two calls."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spun = torch.cuda.Event()
    torch.cuda._sleep(int(SPIN_HZ * max(2.0 * host_s * reps, 0.01)))
    spun.record()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if spun.query():
        print(f"  note ({label}): the spin ended before the host had "
              "enqueued every call; the time below includes launch gaps")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_close(name, got, want, rtol, atol):
    """Elementwise |got - want| <= atol + rtol |want|; returns (max abs,
    max rel) errors."""
    import torch
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    rel = float((diff / want.abs().clamp_min(1e-300)).max())
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements off (max abs "
            f"{float(diff.max()):.3e}, rtol {rtol}, atol {atol})")
    return float(diff.max()), rel


def check_normwise(name, got, want, tol):
    """max |got - want| <= tol * max |want| (sums over many points: the
    order of summation differs, so the error is judged against the scale
    of the whole tensor)."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"{name}: normwise error {err / scale:.3e} > "
                             f"{tol}")
    return err, err / scale if scale else 0.0


def profile_device(fn, reps: int, label: str):
    """torch.profiler over ``reps`` calls of ``fn``: prints the wall time
    per call (host clock, profiler on), the device busy time and idle share,
    and the device time by kernel; returns (wall_ms, busy_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0) / reps

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernel rows only: an operator's row repeats its kernels' device time,
    # and so does the device span of a user annotation (the optimiser's
    # step is one)
    rows = sorted((e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False)),
                  key=dev_us, reverse=True)
    by_kernel = {e.key: dev_us(e) / 1e3 / reps for e in rows}
    busy_ms = sum(by_kernel.values())
    print(f"one {label}: {wall_ms:.4f} ms wall (host clock, profiler on), "
          f"device busy {busy_ms:.4f} ms, idle share "
          f"{1.0 - busy_ms / wall_ms:.4f}")
    for e in rows[:12]:
        if dev_us(e) <= 0:
            break
        print(f"  {dev_us(e) / 1e3 / reps:9.4f} ms  {e.count / reps:6.1f}x  "
              f"{e.key[:90]}")
    sys.stdout.flush()
    return wall_ms, busy_ms, by_kernel


def run_cli(args: list[str]) -> tuple[dict, str]:
    """The port's cli.main in this process: (its last stdout line as JSON,
    its stderr). Both are echoed."""
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli.main(args)
    print(out.getvalue().rstrip())
    last = [ln for ln in err.getvalue().splitlines() if ln.strip()][-3:]
    if last:
        print("  stderr: " + " | ".join(last))
    sys.stdout.flush()
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue()


def k1_width_params(h: int, dt, dev) -> dict:
    """Separable params at width h: the seeded GZ init (whose MLP output
    layers are zero) plus N(0, 0.3^2) noise on every MLP weight, drawn in
    float64, so that every layer shapes psi."""
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    p = ansatz.init_params(config.ModelConfig(arch="separable", hidden=h),
                           seed=h, dtype="float64", device=dev)
    noise = torch.Generator(device=dev).manual_seed(h)
    for k in ("lam1", "lam2", "lamout", "mu1", "mu2", "muout"):
        for f in p[k]:
            p[k][f] = p[k][f] + 0.3 * torch.randn(
                p[k][f].shape, generator=noise, device=dev,
                dtype=torch.float64)
    return ansatz.as_params(p, dt, dev)


def k2_width_params(mcfg, dev) -> dict:
    """Symmetric params (GZ + alpha) at width mcfg.hidden: the seeded init
    plus N(0, 0.3^2) noise on the MLP's and the alpha and beta heads'
    weights (the heads' output layers start at zero), drawn in float64,
    so that every layer shapes psi and the exponents vary with R."""
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    p = ansatz.init_params(mcfg, seed=mcfg.hidden, dtype="float64",
                           device=dev)
    noise = torch.Generator(device=dev).manual_seed(mcfg.hidden)
    for k in ("h1", "h2", "out", "alpha1", "alpha2", "beta1", "beta2"):
        for f in p[k]:
            p[k][f] = p[k][f] + 0.3 * torch.randn(
                p[k][f].shape, generator=noise, device=dev,
                dtype=torch.float64)
    return p


def k2_check(kt, label, ws, args, kw, gen, names):
    """K2-fwd and K2-bwd against the plain versions in float64, at the JAX
    package's Pallas-vs-XLA tolerances (tests/test_pallas_train.py:66-91),
    and two K2-bwd launches bit for bit; returns the worst relative errors
    (psi, lap, backward normwise)."""
    import torch
    psi_k, lap_k = kt.train_fwd_cuda(ws, *args, **kw)
    with torch.no_grad():
        psi_p, lap_p = kt.psi_lap_train_plain(ws, *args, **kw)
    n = args[0].numel()
    dpsi = torch.randn(n, generator=gen, device=args[0].device,
                       dtype=args[0].dtype)
    dlap = torch.randn_like(dpsi)
    dws, da, db, dg = kt.train_bwd_cuda(ws, *args, dpsi, dlap, **kw)
    again = kt.train_bwd_cuda(ws, *args, dpsi, dlap, **kw)
    with torch.no_grad():
        want = kt.psi_lap_train_vjp_plain(ws, *args, dpsi, dlap, **kw)
    torch.cuda.synchronize()
    e_psi = check_close(f"K2-fwd psi {label}", psi_k, psi_p, 1e-12, 1e-14)
    e_lap = check_close(f"K2-fwd lap {label}", lap_k, lap_p, 1e-11, 1e-12)
    got = list(dws) + [da, db, dg]
    worst = max(check_normwise(f"K2-bwd {nm} {label}", u, v, 1e-8)[1]
                for nm, u, v in zip(names, got,
                                    list(want[0]) + list(want[1:])))
    if not all(torch.equal(u, v) for u, v in
               zip(got, list(again[0]) + list(again[1:]))):
        raise AssertionError(f"K2-bwd {label}: two launches differ")
    return e_psi[1], e_lap[1], worst


def k2_phases(dev, card: str) -> list[dict]:
    """Phases 8-12: the residual trainer of the symmetric family and its
    kernel K2. Returns the K2 entries of the kernels line."""
    import numpy as np
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
        energy
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
        checkpoint
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_train as kt
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops.sampling \
        import sample_batch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        engine, losses

    def artifact(name):
        tree, _ = checkpoint.load_params(os.path.join(HERE, "artifacts",
                                                      name))
        return tree["params"]

    phase(f"8 K2 check (make train batch, {N_TRAIN} points)")
    # the make train model: symmetric, GZ + alpha, paper widths
    models = {"flagship": (artifact("flagship.npz"), 1),
              "ungerade_2psu": (artifact("ungerade_2psu.npz"), -1)}
    gen = torch.Generator(device=dev).manual_seed(0)
    errs, inputs = {}, {}
    names = ["h1/w", "h1/b", "h2/w", "h2/b", "out/w", "out/b", "a", "b", "g"]
    for label, (tree, p_sym) in models.items():
        mcfg = config.ModelConfig(inversion_symmetry=p_sym, gz=True,
                                  trainable_exponent=True)
        cfg = config.Config(model=mcfg)
        for dt_name, dt in (("float64", torch.float64),
                            ("float32", torch.float32)):
            params = ansatz.from_jax_params(tree, dtype=dt, device=dev)
            batch = sample_batch(gen, cfg, n=N_TRAIN, dtype=dt, device=dev)
            with torch.no_grad():
                a = ansatz.orbital_exponent(params, batch.r)
                b = ansatz.gz_exponent(params, batch.r, p_sym, a)
                g = ansatz.gate(params, batch.r)
            ws = kt.kernel_weights(params, mcfg, dt)
            args = (a, b, g, batch.x, batch.y, batch.z, batch.r)
            kw = dict(p_sym=p_sym)
            psi_k, lap_k = kt.train_fwd_cuda(ws, *args, **kw)
            with torch.no_grad():
                psi_p, lap_p = kt.psi_lap_train_plain(ws, *args, **kw)
            torch.cuda.synchronize()
            if dt == torch.float64:
                # the JAX package's Pallas-vs-XLA tolerances
                # (tests/test_pallas_train.py:66-91)
                tol_psi, tol_lap, tol_bwd = (1e-12, 1e-14), (1e-11, 1e-12), \
                    1e-8
            else:
                # float32: unit roundoff 6e-8; psi sums the gated network
                # and the GZ pair (O(1) terms that cancel in the ungerade
                # sector), so its absolute floor is set by max |psi|; lap
                # cancels terms up to ~2a/r1 near the nuclei; the weight
                # gradients sum 100 000 points in another order, and in the
                # ungerade sector the two branches cancel
                tol_psi = (1e-4, 4e-6 * float(psi_p.abs().max()))
                tol_lap = (1e-3, 1e-5 * float(lap_p.abs().max()))
                tol_bwd = 5e-4
            e_psi = check_close(f"K2-fwd psi {label} {dt_name}", psi_k,
                                psi_p, *tol_psi)
            e_lap = check_close(f"K2-fwd lap {label} {dt_name}", lap_k,
                                lap_p, *tol_lap)
            dpsi = torch.randn(N_TRAIN, generator=gen, device=dev, dtype=dt)
            dlap = torch.randn(N_TRAIN, generator=gen, device=dev, dtype=dt)
            dws, da, db, dg = kt.train_bwd_cuda(ws, *args, dpsi, dlap, **kw)
            again = kt.train_bwd_cuda(ws, *args, dpsi, dlap, **kw)
            with torch.no_grad():
                want = kt.psi_lap_train_vjp_plain(ws, *args, dpsi, dlap, **kw)
            torch.cuda.synchronize()
            got = list(dws) + [da, db, dg]
            worst = max((check_normwise(f"K2-bwd {nm} {label} {dt_name}",
                                        u, v, tol_bwd)
                         for nm, u, v in zip(names, got,
                                             list(want[0]) + list(want[1:]))),
                        key=lambda e: e[1])
            if not all(torch.equal(u, v) for u, v in
                       zip(got, list(again[0]) + list(again[1:]))):
                raise AssertionError(f"K2-bwd {label} {dt_name}: two "
                                     "launches differ")
            print(f"K2 {label} {dt_name}: fwd psi max abs {e_psi[0]:.3e} "
                  f"rel {e_psi[1]:.3e} | lap max abs {e_lap[0]:.3e} rel "
                  f"{e_lap[1]:.3e} | bwd worst normwise {worst[1]:.3e} (abs "
                  f"{worst[0]:.3e}); two launches bitwise equal")
            if label == "flagship":
                inputs[dt_name] = (ws, args, kw)
                errs[dt_name] = {"fwd": max(e_psi[0], e_lap[0]),
                                 "bwd": worst[0]}
    # the other widths the kernels are built for, in float64 (the
    # reference-parity type), on a make evaluate-sized and a ragged batch
    for h in (4, 8, 32):
        for p_sym in (1, -1):
            for n in (9216, 1100):
                mcfg = config.ModelConfig(inversion_symmetry=p_sym, gz=True,
                                          trainable_exponent=True, hidden=h)
                params = k2_width_params(mcfg, dev)
                batch = sample_batch(gen, config.Config(model=mcfg), n=n,
                                     dtype=torch.float64, device=dev)
                with torch.no_grad():
                    a = ansatz.orbital_exponent(params, batch.r)
                    b = ansatz.gz_exponent(params, batch.r, p_sym, a)
                    g = ansatz.gate(params, batch.r)
                ws = kt.kernel_weights(params, mcfg, torch.float64)
                args = (a, b, g, batch.x, batch.y, batch.z, batch.r)
                e = k2_check(kt, f"H={h} P={p_sym} n={n} float64", ws, args,
                             dict(p_sym=p_sym), gen, names)
                print(f"K2 H={h} P={p_sym} n={n} float64: fwd psi rel "
                      f"{e[0]:.3e} | lap rel {e[1]:.3e} | bwd worst "
                      f"normwise {e[2]:.3e}; two launches bitwise equal")
    sys.stdout.flush()

    phase("9 golden (flagship.npz E_int through K2-fwd, float64)")
    cfg64 = config.Config(dtype="float64", model=config.ModelConfig(
        gz=True, trainable_exponent=True))
    params64 = ansatz.from_jax_params(models["flagship"][0],
                                      dtype="float64", device=dev)
    r_probe = np.array(sorted(JAX_EINT_FLAGSHIP))
    exact = energy.exact_energy_ode(r_probe)
    kt.reset_launches()
    for ri, ex in zip(r_probe, exact):
        e_int = energy.rayleigh_quotient_spheroidal(params64, cfg64,
                                                    float(ri))
        want = JAX_EINT_FLAGSHIP[float(ri)]
        rel = abs(e_int - want) / abs(want)
        print(f"R={ri}: E_int {e_int:.15f} JAX {want:.15f} rel {rel:.2e}; "
              f"exact {ex:.12f}, above by {1e3 * (e_int - ex):.6f} mHa")
        if not rel <= 1e-10:
            raise AssertionError(f"K2 golden missed at R={ri}: rel {rel}")
        if not e_int >= ex:
            raise AssertionError(f"E_int below the exact level at R={ri}")
    if kt.launches["train_fwd"] != len(r_probe):
        raise AssertionError(f"the quotient did not run K2-fwd: "
                             f"{kt.launches}")
    sys.stdout.flush()

    phase(f"10 training (make train: GZ + alpha, step schedule, float32, "
          f"{N_TRAIN} points; {TRAIN_STEPS} steps)")
    tcfg = config.Config(model=config.ModelConfig(gz=True,
                                                  trainable_exponent=True))
    tcfg = tcfg.replace(train=dataclasses.replace(
        tcfg.train, lr_schedule="step", n_train=N_TRAIN, epochs=TRAIN_STEPS,
        scan_chunk=100))
    fixed = sample_batch(torch.Generator(device=dev).manual_seed(1), tcfg,
                         device=dev)

    def fixed_loss(p):
        with torch.no_grad():
            return float(losses.loss_fn(
                ansatz.as_params(p, torch.float32, dev), tcfg, fixed)[0])

    # warm-up outside the counted and timed run: the first steps pay
    # one-time host costs (module loading, kernel library loading)
    engine.train(tcfg.replace(train=dataclasses.replace(
        tcfg.train, epochs=WARMUP_STEPS, scan_chunk=WARMUP_STEPS)),
        device=dev)
    init = ansatz.init_params(tcfg.model, seed=tcfg.train.seed,
                              dtype=torch.float32, device=dev)
    kt.reset_launches()
    torch.cuda.synchronize()
    res = engine.train(tcfg, device=dev,
                       log_cb=lambda step, m: print(
                           f"  {step:5d} " + " ".join(
                               f"{k}={v:.6e}" for k, v in m.items())))
    counts = dict(kt.launches)
    loss0, loss1 = fixed_loss(init), fixed_loss(res.best_params)
    print(f"launches during training: {counts} ({TRAIN_STEPS} steps)")
    print(f"loss on a fixed {N_TRAIN}-point batch: {loss0:.6e} -> "
          f"{loss1:.6e}")
    if not (np.isfinite(loss1) and loss1 < loss0):
        raise AssertionError(f"loss did not decrease: {loss0} -> {loss1}")
    if counts["train_fwd"] <= 0 or counts["train_bwd"] <= 0 or \
            counts["train_bwd_pg"] != 0:
        raise AssertionError(f"training launches: {counts}")
    print(f"training: {TRAIN_STEPS / res.runtime_s:.2f} steps/s, "
          f"{res.points_per_sec:.4e} points/s ({res.runtime_s:.3f} s)")
    fcfg = config.finetune_config(tcfg)
    fcfg = fcfg.replace(train=dataclasses.replace(
        fcfg.train, epochs=FINETUNE_STEPS, scan_chunk=FINETUNE_STEPS))
    kt.reset_launches()
    ft = engine.finetune(fcfg, res.best_params, device=dev)
    ft_counts = dict(kt.launches)
    print(f"fine-tune: {FINETUNE_STEPS / ft.runtime_s:.2f} steps/s, best "
          f"loss {ft.best_loss:.6e}, launches {ft_counts}")
    if ft_counts["train_bwd"] != 0 or ft_counts["train_fwd"] == 0:
        raise AssertionError(f"fine-tune launches: {ft_counts}")
    if not np.isfinite(ft.best_loss):
        raise AssertionError("fine-tune loss is not finite")
    sys.stdout.flush()

    phase(f"11 K2 times (CUDA events, {card})")
    times = {}
    for dt_name in ("float64", "float32"):
        ws, args, kw = inputs[dt_name]
        dpsi = torch.randn(N_TRAIN, generator=gen, device=dev,
                           dtype=args[0].dtype)
        dlap = torch.randn_like(dpsi)
        with torch.no_grad():
            t = {
                "fwd": cuda_ms(lambda: kt.train_fwd_cuda(ws, *args, **kw),
                               label="K2-fwd"),
                "fwd_plain": cuda_ms(
                    lambda: kt.psi_lap_train_plain(ws, *args, **kw), reps=2,
                    label="K2-fwd plain"),
                "bwd": cuda_ms(lambda: kt.train_bwd_cuda(
                    ws, *args, dpsi, dlap, **kw), label="K2-bwd"),
                # up to ~800 torch ops a call: only one call fits the queue
                "bwd_plain": cuda_ms(lambda: kt.psi_lap_train_vjp_plain(
                    ws, *args, dpsi, dlap, **kw), reps=1,
                    label="K2-bwd plain"),
            }
        for which in ("fwd", "bwd"):
            b_ms, b_by = bound_ms(N_TRAIN, 16, dt_name, which, "K2")
            t[which + "_bound"], t[which + "_bound_by"] = b_ms, b_by
        times[dt_name] = t
        print(f"{dt_name} n={N_TRAIN} H=16: K2-fwd {t['fwd']:.4f} ms (plain "
              f"{t['fwd_plain']:.4f}, bound {t['fwd_bound']:.4f} "
              f"{t['fwd_bound_by']}) | K2-bwd {t['bwd']:.4f} ms (plain "
              f"{t['bwd_plain']:.4f}, bound {t['bwd_bound']:.4f} "
              f"{t['bwd_bound_by']})", flush=True)

    phase("12 profile (10 training steps at make train's configuration)")
    pcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, epochs=10,
                                                  scan_chunk=10))
    profile_device(lambda: engine.train(pcfg, device=dev), 1,
                   "run of 10 steps (setup included)")
    # the setup alone (copy of the init, optimiser, first batch): a run
    # that starts at its last step trains none
    profile_device(lambda: engine.train(pcfg, start_step=10, device=dev), 1,
                   "setup alone")

    t32, t64 = times["float32"], times["float64"]
    out = []
    for which, line in (("fwd", 233), ("bwd", 264)):
        out.append({
            "name": f"train_{which}",
            "route": "cuda",
            "source": f"{PKG}/csrc/train_{which}.cu",
            "replaces": ("pinn_for_quantum_wavefunction_surfaces_tpu/ops/"
                         f"pallas_train.py:{line}"),
            "launches": counts[f"train_{which}"],
            "dtype": "float32",
            "max_abs_err": errs["float32"][which],
            "ms": t32[which],
            "plain_ms": t32[f"{which}_plain"],
            "bound_ms": t32[f"{which}_bound"],
            "bound_by": t32[f"{which}_bound_by"],
            "library_ms": None,
            "float64": {"max_abs_err": errs["float64"][which],
                        "ms": t64[which],
                        "plain_ms": t64[f"{which}_plain"],
                        "bound_ms": t64[f"{which}_bound"],
                        "bound_by": t64[f"{which}_bound_by"]},
        })
    return out


# K3's point sets (phase 13) and the cut depth of phase 15's make ref-recipe
# (of 5 000 training and 2 000 fine-tune epochs)
K3_GRID_N, K3_N_UNIFORM = 80, 1 << 20
REF_TRAIN_STEPS, REF_FINETUNE_STEPS = 200, 100


def k3_phases(dev, card: str) -> dict:
    """Phases 13-16: K3 and the forward-only scoring layer (cli energy, cli
    evaluate). Returns the K3 entry of the kernels line."""
    import numpy as np
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
        energy
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
        etab
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
        checkpoint
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_residual as k3
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_train as kt
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        distill

    weights = k3_weights()
    h, hg = weights["h1"]["w"].shape[1], weights["gate1"]["w"].shape[1]
    phase(f"13 K3 check (H = {h}, gate {hg}; {K3_GRID_N}^3 grid at R = 1, "
          f"{K3_N_UNIFORM} uniform points at R = 2)")
    ax = np.linspace(-18.0, 18.0, K3_GRID_N)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    rng = np.random.default_rng(K3_SEED)
    point_sets = {
        "grid": ([a.ravel() for a in (gx, gy, gz)], 1.0),
        "uniform": ([rng.uniform(-18.0, 18.0, K3_N_UNIFORM)
                     for _ in range(3)], 2.0),
    }
    cases = [("grid", 1, 0.0, 0.0), ("grid", -1, 0.0, 0.0),
             ("uniform", 1, 0.0, 0.0), ("uniform", -1, 0.0, 0.0),
             ("uniform", 1, 0.3, -0.2)]
    errs, inputs = {}, {}
    for dt_name, dt in (("float64", torch.float64),
                        ("float32", torch.float32)):
        params = ansatz.from_jax_params(weights, dtype=dt, device=dev)
        worst = 0.0
        for label, p_sym, ry, rz in cases:
            arrays, ri = point_sets[label]
            pts = [torch.as_tensor(a, dtype=dt, device=dev) for a in arrays]
            r = torch.full_like(pts[0], ri)
            mcfg = config.ModelConfig(inversion_symmetry=p_sym, ry=ry, rz=rz)
            ws = k3.kernel_weights(params, mcfg, dt)
            kw = dict(p_sym=p_sym, ry=ry, rz=rz)
            psi_k, lap_k = k3.residual_fwd_cuda(ws, *pts, r, **kw)
            with torch.no_grad():
                psi_p, lap_p = k3.psi_lap_residual_plain(ws, *pts, r, **kw)
                lcao, _ = energy.lcao_fwdlap(mcfg, *pts, r)
            torch.cuda.synchronize()
            share = float((psi_p - lcao).abs().max() / psi_p.abs().max())
            if not share >= 1e-2:
                raise AssertionError(f"K3 {label} P={p_sym}: the correction "
                                     f"is {share:.2e} of psi; it must be a "
                                     "sizeable share")
            if dt == torch.float64:
                # the JAX package's Pallas-vs-XLA tolerances (psi cancels
                # far from the nuclei: an absolute floor)
                tol_psi, tol_lap = (1e-12, 1e-14), (1e-10, 1e-12)
            else:
                # float32: unit roundoff 6e-8; psi sums the gated network
                # and the LCAO pair, O(1) terms that cancel in the ungerade
                # sector, so its absolute floor is set by max |psi|; lap
                # cancels terms up to ~2/r near the nuclei
                tol_psi = (1e-4, 4e-6 * float(psi_p.abs().max()))
                tol_lap = (1e-3, 1e-5 * float(lap_p.abs().max()))
            name = f"K3 {label} P={p_sym} ry={ry} rz={rz} {dt_name}"
            e_psi = check_close(name + " psi", psi_k, psi_p, *tol_psi)
            e_lap = check_close(name + " lap", lap_k, lap_p, *tol_lap)
            print(f"{name}: psi max abs {e_psi[0]:.3e} | lap max abs "
                  f"{e_lap[0]:.3e} rel {e_lap[1]:.3e} | correction share "
                  f"{share:.3f}")
            worst = max(worst, e_psi[0], e_lap[0])
            if ry == 0.0 and p_sym == 1:
                inputs[(dt_name, label)] = (ws, pts, r, kw)
        errs[dt_name] = worst
    sys.stdout.flush()

    times = {}
    for dt_name in ("float64", "float32"):
        for label in ("grid", "uniform"):
            ws, pts, r, kw = inputs[(dt_name, label)]
            n = pts[0].numel()
            with torch.no_grad():
                t = {"ms": cuda_ms(lambda: k3.residual_fwd_cuda(
                         ws, *pts, r, **kw), label="K3"),
                     "plain_ms": cuda_ms(lambda: k3.psi_lap_residual_plain(
                         ws, *pts, r, **kw), reps=2, label="K3 plain")}
            t["bound_ms"], t["bound_by"] = bound_ms(n, h, dt_name, "fwd",
                                                    "K3", hg)
            times[(dt_name, n)] = t
            print(f"{dt_name} n={n} H={h} Hg={hg}: K3 {t['ms']:.4f} ms "
                  f"(plain {t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} "
                  f"{t['bound_by']}; {card})", flush=True)

    phase("14 K3 golden (E_int, E_lcao on the 80^3 and 96 x 96 spheroidal "
          "grids, float64)")
    params64 = ansatz.from_jax_params(weights, dtype="float64", device=dev)
    cfg = config.Config(dtype="float64")
    k3.reset_launches()
    for ri, want in JAX_K3_GOLDEN.items():
        got = (energy.rayleigh_quotient(params64, cfg, ri, n=K3_GRID_N),
               energy.rayleigh_quotient(params64, cfg, ri, n=K3_GRID_N,
                                        which="lcao"),
               energy.rayleigh_quotient_spheroidal(params64, cfg, ri),
               energy.rayleigh_quotient_spheroidal(params64, cfg, ri,
                                                   which="lcao"))
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        print(f"R={ri}: E_int {got[0]:.15f} E_lcao {got[1]:.15f} (80^3); "
              f"E_int {got[2]:.15f} E_lcao {got[3]:.15f} (spheroidal); "
              f"max rel to JAX {max(rel):.2e}")
        if not max(rel) <= 1e-10:
            raise AssertionError(f"K3 golden missed at R={ri}: rel {rel}")
    if k3.launches["residual_fwd"] != 2 * len(JAX_K3_GOLDEN):
        raise AssertionError(f"the model quotients did not all run K3: "
                             f"{k3.launches}")
    sys.stdout.flush()

    phase(f"15 make ref-recipe (cut: {REF_TRAIN_STEPS} + "
          f"{REF_FINETUNE_STEPS} steps, float64), then cli energy at its "
          "defaults")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        s1, s2 = os.path.join(work, "stage1"), os.path.join(work, "stage2")
        kt.reset_launches()
        run_cli(["train", "--out", s1, "--dtype", "float64", "--epochs",
                 str(REF_TRAIN_STEPS)])
        train_counts = dict(kt.launches)
        _, meta = checkpoint.load_params(os.path.join(s1, "final.npz"))
        print(f"cli train (float64): {REF_TRAIN_STEPS / meta['runtime_s']:.2f}"
              f" steps/s; K2 launches {train_counts}")
        if train_counts["train_bwd"] < REF_TRAIN_STEPS:
            raise AssertionError(f"cli train did not run K2-bwd each step: "
                                 f"{train_counts}")
        kt.reset_launches()
        run_cli(["finetune", os.path.join(s1, "best.npz"), "--out", s2,
                 "--dtype", "float64", "--epochs", str(REF_FINETUNE_STEPS)])
        print(f"cli finetune (float64): K2 launches {dict(kt.launches)}")
        ft = os.path.join(s2, "finetune.npz")
        pkl = os.path.join(work, "energy_R_ion.pkl")
        n_r = len(np.round(np.arange(0.2, 4.0 + 0.1, 0.1), 2))
        per = K3_GRID_N * K3_GRID_N
        want_launches = n_r * -(-K3_GRID_N // max(1, energy.CHUNK_POINTS
                                                  // per))
        k3.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        summary, _ = run_cli(["energy", ft, "--out", pkl])
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = dict(k3.launches)
        surf = energy.load_surface(pkl)
        if sorted(surf) != ["E_int", "E_net", "Elcao", "R"] or any(
                len(v) != n_r for v in surf.values()):
            raise AssertionError(f"the surface pickle's schema: "
                                 f"{ {k: np.shape(v) for k, v in surf.items()} }")
        if not all(np.all(np.isfinite(v)) for v in surf.values()) or \
                not all(np.isfinite([summary["max_err_mHa"],
                                     summary["mean_err_mHa"]])):
            raise AssertionError("the surface or its errors are not finite")
        if counts["residual_fwd"] != want_launches:
            raise AssertionError(f"cli energy launched K3 "
                                 f"{counts['residual_fwd']} times, the "
                                 f"chunking implies {want_launches}")
        pts_model = n_r * K3_GRID_N ** 3
        print(f"cli energy: {n_r} R in {wall:.3f} s, {pts_model / wall:.4e} "
              f"model points/s ({2 * pts_model / wall:.4e} with the LCAO "
              f"quotients); K3 launches {counts}; E_int at R=1 "
              f"{surf['E_int'][8]:.9f}, E_lcao {surf['Elcao'][8]:.9f}, "
              f"E_net {surf['E_net'][8]:.9f}")
        params_ft = ansatz.from_jax_params(
            _load_npz_params(ft), device=dev)
        cfg_ft = config.Config()
        _, busy, by_kernel = profile_device(
            lambda: energy.surface(params_ft, cfg_ft,
                                   r_values=[1.0, 2.0, 3.0]), 1,
            "surface of 3 R (model and LCAO quotients)")
        k3_ms = sum(v for k, v in by_kernel.items() if "residual_fwd" in k)
        print(f"K3's share of the device time: {k3_ms / busy:.4f} "
              f"({k3_ms:.4f} of {busy:.4f} ms)", flush=True)

        phase("16 make evaluate (cli evaluate artifacts/flagship_separable"
              ".npz --steps 8000 --dtype float64)")
        src = os.path.join(HERE, "artifacts", "flagship_separable.npz")
        out_dir = os.path.join(work, "evaluate")
        n_quot = (len(np.round(np.arange(0.2, 4.0 + 0.05, 0.05), 3)) + 153
                  + n_r)
        ks.reset_launches()
        t0 = time.time()
        res, err = run_cli(["evaluate", src, "--dtype", "float64",
                            "--steps", "8000", "--out", out_dir])
        walls = json.loads(err.strip().splitlines()[-1].split(": ", 1)[1])
        print(f"cli evaluate: {time.time() - t0:.1f} s; "
              + err.strip().splitlines()[-1])
        print(f"the E-head fit ran on {distill.FIT_DEVICE} in "
              f"{walls['fit']} s (params on {dev})")
        ev_counts = dict(ks.launches)
        got = etab.load_table(os.path.join(out_dir, "evaluated.npz"))
        want = etab.load_table(os.path.join(HERE, "artifacts",
                                            "evaluated.npz"))
        if not np.array_equal(got["R"], want["R"]):
            raise AssertionError("the table's knots differ from the shipped")
        rel = np.abs(got["E"] - want["E"]) / np.abs(want["E"])
        print(f"e_table/E against artifacts/evaluated.npz: max rel "
              f"{rel.max():.3e} over {len(rel)} knots; launches {ev_counts} "
              f"for {n_quot} quotients")
        checks = {
            "e_table/E equal to the shipped to 1e-10": rel.max() <= 1e-10,
            "int_min_signed_mHa >= -1e-4": res["int_min_signed_mHa"]
            >= -1e-4,
            "int_max_err_mHa <= 0.01": res["int_max_err_mHa"] <= 0.01,
            "tab_mean_err_mHa <= 0.001": res["tab_mean_err_mHa"] <= 0.001,
            "fit_rms_mHa <= 0.01": res["fit_rms_mHa"] <= 0.01,
            "one K1-fwd launch a quotient": ev_counts == {
                "separable_fwd": n_quot, "separable_bwd": 0,
                "separable_bwd_pg": 0},
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"make evaluate: {failed}")
        sys.stdout.flush()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    t = times[("float64", K3_GRID_N ** 3)]
    return {
        "name": "residual_fwd",
        "route": "cuda",
        "source": f"{PKG}/csrc/residual_fwd.cu",
        "replaces": ("pinn_for_quantum_wavefunction_surfaces_tpu/ops/"
                     "pallas_residual.py:200"),
        "launches": counts["residual_fwd"],
        "dtype": "float64",
        "max_abs_err": errs["float64"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }


# phase 17: the slice of the path held against the CPU, and the central
# differences' points and step
PG_CPU_POINTS, PG_FD_POINTS, PG_FD_H = 4096, 64, 1e-5


def pg_check(kind, label, ws, args, kw, gen, tol_w, tol_p):
    """A PG = true launch of K1-bwd or K2-bwd against the plain point_grads
    VJP (every output normwise: the weight gradients and da, db (dg) to
    tol_w, dx..dr to tol_p), and two PG launches bit for bit; the weight
    gradients' largest normwise difference to the training launch's is
    printed. Returns (worst abs, worst normwise) over all outputs."""
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_train as kt
    if kind == "K1":
        bwd, vjp = ks.separable_bwd_cuda, ks.psi_lap_separable_vjp_plain
        names = [f"{m}{k}/{f}" for m in ("lam", "mu")
                 for k, f in (("1", "w"), ("1", "b"), ("2", "w"), ("2", "b"),
                              ("out", "w"), ("out", "b"))] + ["a", "b"]
    else:
        bwd, vjp = kt.train_bwd_cuda, kt.psi_lap_train_vjp_plain
        names = ["h1/w", "h1/b", "h2/w", "h2/b", "out/w", "out/b", "a", "b",
                 "g"]
    names += ["x", "y", "z", "r"]
    n = args[-1].numel()
    dpsi = torch.randn(n, generator=gen, device=args[0].device,
                       dtype=args[0].dtype)
    dlap = torch.randn_like(dpsi)

    def flat(out):
        return list(out[0]) + list(out[1:])

    got = flat(bwd(ws, *args, dpsi, dlap, point_grads=True, **kw))
    again = flat(bwd(ws, *args, dpsi, dlap, point_grads=True, **kw))
    off = flat(bwd(ws, *args, dpsi, dlap, **kw))
    with torch.no_grad():
        want = flat(vjp(ws, *args, dpsi, dlap, point_grads=True, **kw))
    torch.cuda.synchronize()
    errs = [check_normwise(f"{kind}-bwd PG {nm} {label}", u, v,
                           tol_p if nm in "xyzr" else tol_w)
            for nm, u, v in zip(names, got, want)]
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise AssertionError(f"{kind}-bwd PG {label}: two launches differ")
    to_off = max(float((u - v).abs().max() / v.abs().max().clamp_min(1e-300))
                 for u, v in zip(got, off))
    pts = [e for nm, e in zip(names, errs) if nm in "xyzr"]
    print(f"{kind}-bwd PG {label}: worst normwise {max(e[1] for e in errs):.3e}"
          f" (dx..dr {max(e[1] for e in pts):.3e}, abs "
          f"{max(e[0] for e in pts):.3e}); two launches bitwise equal; the "
          f"training launch's outputs within {to_off:.3e} normwise")
    return max(e[0] for e in errs), max(e[1] for e in errs)


def pg_phase(dev, card: str) -> list[dict]:
    """Phase 17: the point cotangents of K1-bwd and K2-bwd
    (point_grads=True). Returns their entries of the kernels line."""
    import numpy as np
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
        checkpoint
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_train as kt
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops.sampling \
        import sample_batch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        variational

    phase("17 point cotangents (K1-bwd and K2-bwd, point_grads=True)")

    def artifact(name):
        tree, _ = checkpoint.load_params(os.path.join(HERE, "artifacts",
                                                      name))
        return tree["params"]

    gen = torch.Generator(device=dev).manual_seed(17)
    both = (("float64", torch.float64), ("float32", torch.float32))
    # the path at the shipped models' sizes: K1 at the flagship batch, K2 at
    # the make-train batch in both sectors
    sep_cfg = config.Config(model=config.ModelConfig(arch="separable"),
                            dtype="float64")
    vb = variational.dual_grid_vbatch(sep_cfg, N_R, N_XI, N_ETA, device=dev)
    k1_pts = [t.reshape(-1) for t in (vb.x, vb.y, vb.z)] + [
        vb.r[:, None].expand_as(vb.x).reshape(-1)]
    cases = []   # (kernel, label, entry point, model config, tree, points)
    for dt_name, dt in both:
        cases.append(("K1", f"flagship {dt_name}",
                      ks.psi_lap_train_separable, sep_cfg.model,
                      artifact("flagship_separable.npz"),
                      [t.to(dt).contiguous() for t in k1_pts]))
        for name, p_sym in (("flagship", 1), ("ungerade_2psu", -1)):
            mcfg = config.ModelConfig(inversion_symmetry=p_sym, gz=True,
                                      trainable_exponent=True)
            batch = sample_batch(gen, config.Config(model=mcfg), n=N_TRAIN,
                                 dtype=dt, device=dev)
            cases.append(("K2", f"{name} P={p_sym} {dt_name}",
                          kt.psi_lap_train, mcfg, artifact(f"{name}.npz"),
                          [batch.x, batch.y, batch.z, batch.r]))

    def path_grads(fn, params, mcfg, pts):
        """d/d(x, y, z, r) of sum(psi^2) + sum(lap) through the entry point
        with point_grads=True."""
        xyzr = [t.detach().clone().requires_grad_(True) for t in pts]
        psi, lap, _ = fn(params, mcfg, *xyzr, point_grads=True)
        return torch.autograd.grad((psi * psi).sum() + lap.sum(), xyzr)

    params = {c[1]: ansatz.from_jax_params(c[4], dtype=c[5][0].dtype,
                                           device=dev) for c in cases}
    ks.reset_launches()
    kt.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    grads = {c[1]: path_grads(c[2], params[c[1]], c[3], c[5]) for c in cases}
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {**ks.launches, **kt.launches}
    print(f"the path (autograd in x, y, z, r through the entry points, "
          f"{len(cases)} cases) in {wall:.3f} s; launches {counts}")
    n_k1 = sum(c[0] == "K1" for c in cases)
    if counts != {"separable_fwd": n_k1, "separable_bwd": 0,
                  "separable_bwd_pg": n_k1, "train_fwd": len(cases) - n_k1,
                  "train_bwd": 0, "train_bwd_pg": len(cases) - n_k1}:
        raise AssertionError(f"the point-gradient path's launches: {counts}")
    for label, gs in grads.items():
        if not all(bool(torch.isfinite(g).all()) for g in gs):
            raise AssertionError(f"{label}: point gradients not finite")
    # the path's composition (kernel, heads, autograd) against the CPU's
    # plain path on a slice of each float64 batch
    for kind, label, fn, mcfg, tree, pts in cases:
        if not label.endswith("float64"):
            continue
        sl = [t[:PG_CPU_POINTS] for t in pts]
        got = path_grads(fn, params[label], mcfg, sl)
        want = path_grads(fn, ansatz.from_jax_params(
            tree, dtype=torch.float64, device="cpu"), mcfg,
            [t.cpu() for t in sl])
        errs = [check_normwise(f"{kind} path d{c} {label}", u.cpu(), v, 1e-8)
                for c, u, v in zip("xyzr", got, want)]
        print(f"{kind} path {label}: d(x, y, z, r) against the CPU on "
              f"{PG_CPU_POINTS} points, worst normwise "
              f"{max(e[1] for e in errs):.3e}")
    sys.stdout.flush()

    # the PG kernels against the plain point_grads VJPs, at the path's
    # sizes and at the other widths on a ragged batch in both sectors
    errs, inputs = {}, {}
    for kind, label, fn, mcfg, tree, pts in cases:
        p = params[label]
        dt = pts[0].dtype
        p_sym = mcfg.inversion_symmetry
        kw = dict(p_sym=p_sym, ry=mcfg.ry, rz=mcfg.rz)
        r = pts[3]
        with torch.no_grad():
            a = ansatz.orbital_exponent(p, r)
            b = ansatz.gz_exponent(p, r, p_sym, a)
            if kind == "K1":
                ws, args = ks.kernel_weights(p, dt), (a, b, *pts)
            else:
                ws = kt.kernel_weights(p, mcfg, dt)
                args = (a, b, ansatz.gate(p, r), *pts)
        if dt == torch.float64:
            # the JAX package's gradient tolerance (normwise here: sums over
            # the points in another order; the ungerade branches cancel)
            tol_w = tol_p = 1e-8
        else:
            # float32, as phases 3 and 8 hold the weight gradients; the
            # point gradients differentiate lap psi once more, whose terms
            # cancel up to ~2a/r1 near the nuclei
            tol_w = tol_p = 1e-4 if kind == "K1" else 5e-4
        e = pg_check(kind, label, ws, args, kw, gen, tol_w, tol_p)
        errs[label] = e[0]
        inputs[label] = (ws, args, kw)
    for kind in ("K1", "K2"):
        for h in (4, 8, 32):
            for p_sym in (1, -1):
                n = 1100
                if kind == "K1":
                    p = k1_width_params(h, torch.float64, dev)
                    u = torch.rand((4, n), generator=gen, device=dev,
                                   dtype=torch.float64)
                    pts = [12.0 * u[0] - 6.0, 12.0 * u[1] - 6.0,
                           12.0 * u[2] - 6.0, 0.5 + 2.5 * u[3]]
                else:
                    mcfg = config.ModelConfig(inversion_symmetry=p_sym,
                                              gz=True,
                                              trainable_exponent=True,
                                              hidden=h)
                    p = k2_width_params(mcfg, dev)
                    bt = sample_batch(gen, config.Config(model=mcfg), n=n,
                                      dtype=torch.float64, device=dev)
                    pts = [bt.x, bt.y, bt.z, bt.r]
                with torch.no_grad():
                    a = ansatz.orbital_exponent(p, pts[3])
                    b = ansatz.gz_exponent(p, pts[3], p_sym, a)
                    if kind == "K1":
                        ws, args = ks.kernel_weights(p, torch.float64), \
                            (a, b, *pts)
                    else:
                        ws = kt.kernel_weights(p, mcfg, torch.float64)
                        args = (a, b, ansatz.gate(p, pts[3]), *pts)
                pg_check(kind, f"H={h} P={p_sym} n={n} float64", ws, args,
                         dict(p_sym=p_sym), gen, 1e-8, 1e-8)
    sys.stdout.flush()

    # central differences of the forward kernels, independent of the plain
    # versions: at 64 float64 points clear of the nuclei (the JAX tests'
    # point sets), dx and dR for the cotangents (1, 0) (d psi) and (0, 1)
    # (d lap psi); h = 1e-5: truncation ~h^2 and roundoff ~eps/h, both far
    # below rtol 1e-6 (with a floor of 1e-6 of the largest derivative)
    rng = np.random.default_rng(PG_FD_POINTS)
    m = PG_FD_POINTS
    fd_pts = [torch.as_tensor(v, dtype=torch.float64, device=dev) for v in
              (rng.uniform(-6, 6, m), rng.uniform(-6, 6, m),
               rng.uniform(-6, 6, m), rng.uniform(0.5, 3.0, m))]
    one = torch.ones(m, dtype=torch.float64, device=dev)
    zero = torch.zeros_like(one)
    hh = PG_FD_H
    for kind, label, fn, mcfg, tree, _ in cases:
        if not label.endswith("float64"):
            continue
        p_sym = mcfg.inversion_symmetry
        for sector in ((p_sym,) if kind == "K2" else (1, -1)):
            p = params[label]
            kw = dict(p_sym=sector)
            r = fd_pts[3]
            with torch.no_grad():
                a = ansatz.orbital_exponent(p, r)
                b = ansatz.gz_exponent(p, r, sector, a)
                if kind == "K1":
                    ws, head = ks.kernel_weights(p, torch.float64), (a, b)
                    fwd, bwd = ks.separable_fwd_cuda, ks.separable_bwd_cuda
                else:
                    ws = kt.kernel_weights(p, mcfg, torch.float64)
                    head = (a, b, ansatz.gate(p, r))
                    fwd, bwd = kt.train_fwd_cuda, kt.train_bwd_cuda
            worst = 0.0   # normwise: against the largest derivative
            for out_i, cot in enumerate(((one, zero), (zero, one))):
                res = bwd(ws, *head, *fd_pts, *cot, point_grads=True, **kw)
                for c, k in (("x", 0), ("R", 3)):
                    up = list(fd_pts)
                    dn = list(fd_pts)
                    up[k] = fd_pts[k] + hh
                    dn[k] = fd_pts[k] - hh
                    fd = (fwd(ws, *head, *up, **kw)[out_i]
                          - fwd(ws, *head, *dn, **kw)[out_i]) / (2.0 * hh)
                    got = res[-4] if c == "x" else res[-1]
                    e = check_close(
                        f"{kind} {'lap' if out_i else 'psi'} d{c} P={sector} "
                        "against central differences", got, fd, 1e-6,
                        1e-6 * float(fd.abs().max()))
                    worst = max(worst, e[0] / float(fd.abs().max()))
            print(f"{kind} {label} P={sector}: dx, dR of psi and lap psi "
                  f"against central differences at {m} points, worst "
                  f"normwise {worst:.3e}")
    sys.stdout.flush()

    times = {}
    for kind, label, fn, mcfg, tree, pts in cases:
        if not label.startswith("flagship"):
            continue
        ws, args, kw = inputs[label]
        dt_name = label.split()[-1]
        n = pts[0].numel()
        dpsi = torch.randn(n, generator=gen, device=dev, dtype=pts[0].dtype)
        dlap = torch.randn_like(dpsi)
        bwd, vjp = ((ks.separable_bwd_cuda, ks.psi_lap_separable_vjp_plain)
                    if kind == "K1" else
                    (kt.train_bwd_cuda, kt.psi_lap_train_vjp_plain))
        with torch.no_grad():
            t = {"train": cuda_ms(lambda: bwd(ws, *args, dpsi, dlap, **kw),
                                  label=f"{kind}-bwd"),
                 "pg": cuda_ms(lambda: bwd(ws, *args, dpsi, dlap,
                                           point_grads=True, **kw),
                               label=f"{kind}-bwd PG"),
                 "pg_plain": cuda_ms(lambda: vjp(ws, *args, dpsi, dlap,
                                                 point_grads=True, **kw),
                                     reps=1, label=f"{kind}-bwd PG plain")}
        t["train_again"] = cuda_ms(
            lambda: bwd(ws, *args, dpsi, dlap, **kw), label=f"{kind}-bwd")
        t["bound"], t["bound_by"] = bound_ms(n, 16, dt_name, "bwd_pg", kind)
        times[(kind, dt_name)] = t
        print(f"{dt_name} n={n} H=16: {kind}-bwd PG {t['pg']:.4f} ms against "
              f"the training launch's {t['train']:.4f} / "
              f"{t['train_again']:.4f} (before, after); plain PG "
              f"{t['pg_plain']:.4f}, bound {t['bound']:.4f} {t['bound_by']} "
              f"({card})", flush=True)

    out = []
    for kind, name, line, primary in (
            ("K1", "separable_bwd_pg", "pallas_separable.py:325", "float64"),
            ("K2", "train_bwd_pg", "pallas_train.py:264", "float32")):
        other = "float32" if primary == "float64" else "float64"

        def numbers(dt_name):
            t = times[(kind, dt_name)]
            err = errs[f"flagship {dt_name}" if kind == "K1"
                       else f"flagship P=1 {dt_name}"]
            return {"max_abs_err": err, "ms": t["pg"],
                    "plain_ms": t["pg_plain"], "bound_ms": t["bound"],
                    "bound_by": t["bound_by"]}

        entry = {"name": name, "route": "cuda",
                 "source": f"{PKG}/csrc/{name[:-3]}.cu",
                 "replaces": ("pinn_for_quantum_wavefunction_surfaces_tpu/"
                              f"ops/{line}"),
                 "launches": counts[name], "dtype": primary}
        entry.update(numbers(primary))
        entry["library_ms"] = None
        entry[other] = numbers(other)
        out.append(entry)
    return out


def _load_npz_params(path: str) -> dict:
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
        checkpoint
    tree, _ = checkpoint.load_params(path)
    return tree.get("params", tree)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        __import__(PKG)
    except ImportError as exc:
        print(f"chip_smoke: the port ({PKG}) is not beside this script: "
              f"{exc}", file=sys.stderr)
        return 1
    import numpy as np
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
        energy
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
        checkpoint
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        _build
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_train as kt
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        variational

    t_start = time.time()
    dev = torch.device("cuda")
    # full float32 in the plain matmuls (the yardstick of the f32 check)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 header")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    phase("2 build")
    t0 = time.time()
    _build.build()
    print(f"built {', '.join(_build.KERNELS)} in {time.time() - t0:.1f} s; "
          "each done after " + ", ".join(
              f"{k} {v:.1f} s" for k, v in _build.build_seconds.items()))
    for name in _build.KERNELS:
        for line in ptxas_summary(_build.log_path(name).read_text()):
            print(f"  {name} {line}")
    for mod, name, pg in ((ks, "separable_fwd", False),
                          (ks, "separable_bwd", False),
                          (ks, "separable_bwd", True),
                          (kt, "train_fwd", False), (kt, "train_bwd", False),
                          (kt, "train_bwd", True)):
        for dt in (torch.float64, torch.float32):
            threads = ks.THREADS if mod is ks else kt.threads(dt)
            for h in mod.SUPPORTED_HIDDEN:
                blocks, smem = mod.occupancy(name, h, dt, pg)
                print(f"  {name}{' PG' if pg else ''} {str(dt)[6:]} H={h}: "
                      f"{smem} B shared memory a block of {threads} "
                      f"threads, {blocks} resident blocks per SM "
                      f"({blocks * threads // 32} warps)")
    sys.stdout.flush()

    phase("3 kernel check (flagship training batch; one make evaluate "
          "quotient)")
    art, _ = checkpoint.load_params(
        os.path.join(HERE, "artifacts", "flagship_separable.npz"))
    art = art.get("params", art)
    cfg = config.Config(model=config.ModelConfig(arch="separable"),
                        dtype="float64")
    mcfg = cfg.model
    hidden = art["lam1"]["w"].shape[1]
    vb = variational.dual_grid_vbatch(cfg, N_R, N_XI, N_ETA, device=dev)
    n_train = vb.x.numel()
    # a quotient of make evaluate: the 96 x 96 spheroidal grid at one R
    vb_eval = variational.spheroidal_vbatch(cfg, n_r=1, n_xi=96, n_eta=96,
                                            r_values=[1.0], device=dev)
    kw = dict(p_sym=mcfg.inversion_symmetry, ry=mcfg.ry, rz=mcfg.rz)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs, inputs = {}, {}
    both = (("float64", torch.float64), ("float32", torch.float32))
    # the flagship weights at the flagship batch and at one make evaluate
    # quotient in both types; the other widths the kernels are built for
    # at that quotient in float64, the flagship's type
    cases = [("flagship", vb, None, both), ("evaluate", vb_eval, None, both)]
    cases += [(f"H={h}", vb_eval, h, both[:1])
              for h in ks.SUPPORTED_HIDDEN if h != hidden]
    for batch_name, batch, h, (dt_name, dt) in (
            (c[0], c[1], c[2], d) for c in cases for d in c[3]):
        params = (ansatz.from_jax_params(art, dtype=dt, device=dev)
                  if h is None else k1_width_params(h, dt, dev))
        rr = batch.r[:, None].expand_as(batch.x).reshape(-1).to(dt)
        pts = [t.reshape(-1).to(dt).contiguous()
               for t in (batch.x, batch.y, batch.z)]
        n_pts = rr.numel()
        label = f"{dt_name} n={n_pts}" + ("" if h is None else f" H={h}")
        with torch.no_grad():
            a = ansatz.orbital_exponent(params, rr)
            b = ansatz.gz_exponent(params, rr, mcfg.inversion_symmetry, a)
        ws = ks.kernel_weights(params, dt)
        args = (a, b, *pts, rr)
        psi_k, lap_k = ks.separable_fwd_cuda(ws, *args, **kw)
        with torch.no_grad():
            psi_p, lap_p = ks.psi_lap_separable_plain(ws, *args, **kw)
        torch.cuda.synchronize()
        if dt == torch.float64:
            # the JAX package's own Pallas-vs-XLA tolerances
            tol_psi, tol_lap = (1e-12, 1e-14), (1e-10, 1e-12)
            tol_bwd = 1e-9
        else:
            # float32: unit roundoff 6e-8; psi passes ~2H + 10 roundings
            # and exp of O(3) arguments; lap cancels terms up to ~2a/r1
            # (~1e3 |lap| near the nuclei), so it gets an absolute floor at
            # its own scale; gradients sum 164k points in another order
            tol_psi = (1e-5, 1e-7 * float(psi_p.abs().max()))
            tol_lap = (1e-4, 1e-5 * float(lap_p.abs().max()))
            tol_bwd = 1e-4
        e_psi = check_close(f"K1-fwd psi {label}", psi_k, psi_p, *tol_psi)
        e_lap = check_close(f"K1-fwd lap {label}", lap_k, lap_p, *tol_lap)
        print(f"K1-fwd {label}: psi max abs {e_psi[0]:.3e} rel "
              f"{e_psi[1]:.3e} | lap max abs {e_lap[0]:.3e} rel "
              f"{e_lap[1]:.3e}")
        # backward against autograd of the plain forward
        dpsi = torch.randn(n_pts, generator=gen, device=dev, dtype=dt)
        dlap = torch.randn(n_pts, generator=gen, device=dev, dtype=dt)
        ws_g = [w.clone().requires_grad_(True) for w in ws]
        a_g, b_g = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        pp, ll = ks.psi_lap_separable_plain(ws_g, a_g, b_g, *pts, rr, **kw)
        ref = torch.autograd.grad((pp * dpsi).sum() + (ll * dlap).sum(),
                                  ws_g + [a_g, b_g])
        dws, da, db = ks.separable_bwd_cuda(ws, *args, dpsi, dlap, **kw)
        dws2, da2, db2 = ks.separable_bwd_cuda(ws, *args, dpsi, dlap, **kw)
        torch.cuda.synchronize()
        got = list(dws) + [da, db]
        names = ["lam1/w", "lam1/b", "lam2/w", "lam2/b", "lamout/w",
                 "lamout/b", "mu1/w", "mu1/b", "mu2/w", "mu2/b", "muout/w",
                 "muout/b", "a", "b"]
        worst = max((check_normwise(f"K1-bwd {nm} {label}", g, r_,
                                    tol_bwd)
                     for nm, g, r_ in zip(names, got, ref)),
                    key=lambda e: e[1])
        repeat = all(torch.equal(u, v) for u, v in
                     zip(got, list(dws2) + [da2, db2]))
        if not repeat:
            raise AssertionError(f"K1-bwd {label}: two launches differ")
        print(f"K1-bwd {label}: worst normwise {worst[1]:.3e} (abs "
              f"{worst[0]:.3e}); two launches bitwise equal")
        if batch_name == "flagship":
            inputs[dt_name] = (ws, args)
            errs[dt_name] = {"fwd": max(e_psi[0], e_lap[0]),
                             "bwd": worst[0]}
    sys.stdout.flush()

    phase("4 scoring (flagship E_int through K1-fwd)")
    params64 = ansatz.from_jax_params(art, dtype="float64", device=dev)
    r_probe = np.array([0.2, 1.0, 2.0, 4.0])
    exact = energy.exact_energy_ode(r_probe)
    for ri, ex in zip(r_probe, exact):
        e_int = energy.rayleigh_quotient_spheroidal(params64, cfg, float(ri))
        err_mha = 1e3 * (e_int - ex)
        print(f"R={ri}: E_int {e_int:.12f} exact {ex:.12f} "
              f"err {err_mha:+.6f} mHa")
        if not -1e-4 <= err_mha <= 0.01:
            raise AssertionError(f"E_int golden missed at R={ri}: "
                                 f"{err_mha} mHa")
    sys.stdout.flush()

    phase("5 training (flagship recipe sizes, float64, seeded GZ init)")
    init = ansatz.init_params(mcfg, seed=cfg.train.seed, dtype="float64",
                              device=dev)
    with torch.no_grad():
        loss0 = float(variational.quotient_loss(init, cfg, vb)[0])
    marks = {}

    def log_cb(step, metrics):
        if "E_adam" in metrics and step == ADAM_STEPS:
            torch.cuda.synchronize()
            marks["adam_end"] = time.time()
            marks["adam_counts"] = dict(ks.launches)
        print(f"  {step:5d} " + " ".join(f"{k}={v:.9e}"
                                         for k, v in metrics.items()))

    # warm-up outside the counted and timed run: the first optimiser steps
    # pay one-time host costs (lazy imports and module loading)
    variational.polish_spheroidal(init, cfg, n_r=2, n_xi=8, n_eta=6,
                                  steps=2, adam_steps=2, device=dev)
    ks.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    out = variational.polish_spheroidal(
        init, cfg, n_r=N_R, n_xi=N_XI, n_eta=N_ETA, steps=LBFGS_STEPS,
        adam_steps=ADAM_STEPS, log_cb=log_cb, device=dev)
    torch.cuda.synchronize()
    t1 = time.time()
    counts = dict(ks.launches)
    with torch.no_grad():
        loss1 = float(variational.quotient_loss(out, cfg, vb)[0])
    print(f"launches during the run: {counts}")
    print(f"loss {loss0:.9f} -> {loss1:.9f}")
    if not (np.isfinite(loss1) and loss1 < loss0):
        raise AssertionError(f"loss did not decrease: {loss0} -> {loss1}")
    if counts["separable_fwd"] <= 0 or counts["separable_bwd"] <= 0 or \
            counts["separable_bwd_pg"] != 0:
        raise AssertionError(f"polish launches: {counts}")
    t_adam = marks["adam_end"] - t0
    t_lbfgs = t1 - marks["adam_end"]
    lb = {k: (counts[k] - marks["adam_counts"][k]) / LBFGS_STEPS
          for k in counts}
    print(f"Adam: {ADAM_STEPS / t_adam:.2f} steps/s, "
          f"{ADAM_STEPS * n_train / t_adam:.4e} points/s (one fwd+bwd of "
          f"{n_train} points a step); L-BFGS: {LBFGS_STEPS / t_lbfgs:.2f} "
          f"steps/s, launches per step {lb} (the validation-grid forward "
          f"included); whole run {t1 - t0:.2f} s")
    # a step evaluates the loss and its gradient at its start, then in the
    # line search: one K1-bwd launch an evaluation
    print(f"line-search evaluations per L-BFGS step: "
          f"{lb['separable_bwd'] - 1:.2f} (budget "
          f"{variational.LBFGS_MAX_LS})", flush=True)

    phase(f"6 times (CUDA events, {card})")
    times = {}
    for dt_name in ("float64", "float32"):
        ws, args = inputs[dt_name]
        dpsi = torch.randn(n_train, generator=gen, device=dev,
                           dtype=args[0].dtype)
        dlap = torch.randn_like(dpsi)
        with torch.no_grad():
            t = {
                "fwd": cuda_ms(lambda: ks.separable_fwd_cuda(ws, *args, **kw)),
                "fwd_plain": cuda_ms(
                    lambda: ks.psi_lap_separable_plain(ws, *args, **kw),
                    reps=2),
                "bwd": cuda_ms(lambda: ks.separable_bwd_cuda(
                    ws, *args, dpsi, dlap, **kw)),
                "bwd_plain": cuda_ms(lambda: ks.psi_lap_separable_vjp_plain(
                    ws, *args, dpsi, dlap, **kw), reps=2),
            }
        for which in ("fwd", "bwd"):
            b_ms, b_by = bound_ms(n_train, hidden, dt_name, which)
            t[which + "_bound"], t[which + "_bound_by"] = b_ms, b_by
        times[dt_name] = t
        print(f"{dt_name} n={n_train} H={hidden}: K1-fwd {t['fwd']:.4f} ms "
              f"(plain {t['fwd_plain']:.4f}, bound {t['fwd_bound']:.4f} "
              f"{t['fwd_bound_by']}) | K1-bwd {t['bwd']:.4f} ms (plain "
              f"{t['bwd_plain']:.4f}, bound {t['bwd_bound']:.4f} "
              f"{t['bwd_bound_by']})", flush=True)

    phase("7 profile (quotient_loss forward + backward at the flagship "
          "batch, float64)")
    prof_params = {k: {f: t.detach().clone().requires_grad_(True)
                       for f, t in v.items()} for k, v in init.items()}

    def train_eval():
        variational.quotient_loss(prof_params, cfg, vb)[0].backward()

    for _ in range(3):
        train_eval()
    profile_device(train_eval, 10, "evaluation")

    k2 = k2_phases(dev, card)
    k3_entry = k3_phases(dev, card)
    pg = pg_phase(dev, card)
    phase()

    t64 = times["float64"]
    kernels = []
    for which, line in (("fwd", 293), ("bwd", 325)):
        kernels.append({
            "name": f"separable_{which}",
            "route": "cuda",
            "source": f"{PKG}/csrc/separable_{which}.cu",
            "replaces": ("pinn_for_quantum_wavefunction_surfaces_tpu/ops/"
                         f"pallas_separable.py:{line}"),
            "launches": counts[f"separable_{which}"],
            "dtype": "float64",
            "max_abs_err": errs["float64"][which],
            "ms": t64[which],
            "plain_ms": t64[f"{which}_plain"],
            "bound_ms": t64[f"{which}_bound"],
            "bound_by": t64[f"{which}_bound_by"],
            "library_ms": None,
        })
    kernels += k2 + [k3_entry] + pg
    print(f"smoke run {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
