#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught and passed over):
 1. header: the card's name and power limit, torch and CUDA versions,
    whether matplotlib is installed;
 2. build: the five CUDA kernels from csrc/ (K1 and K2, forward and
    backward, and K3, each in float64, float32 and bfloat16) and the bench
    line's ceiling chains (csrc/ceiling.cu), one nvcc per source, all in
    parallel; ptxas registers and spills of every instantiation (the
    backward kernels' point-gradient ones marked PG), and no K3
    instantiation, and no float32 or bfloat16 training instantiation of
    K1, at H <= 16 may spill; the shared memory per block and
    resident blocks per SM of K1 and K2 at every width in the three types,
    PG too, and of K3 at every width and gate width 1, 10 and 256;
 K1, the separable-spheroidal variational trainer (make flagship):
 3. kernel check at the flagship training batch (164 502 points of the
    dual spheroidal grid, artifacts/flagship_separable.npz weights), in
    float64 and float32: K1-fwd against the plain forward, K1-bwd against
    autograd of the plain forward under seeded random cotangents, and two
    K1-bwd launches equal bit for bit; the same at 9 216 points (one
    spheroidal quotient of make evaluate), and at that quotient at the
    other widths (H = 4, 8, 32; seeded weights) in both types;
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
    1 048 576 uniform points in +-18 at R = 2 and at R per point in
    [0.2, 4], P = +1 and -1 (and one case with ry, rz != 0), and on a
    ragged batch of 1 100 points with R per point at the paper widths and
    at H = 4, 8, 16, 32 with gates of 1 and 256 units, in float64 and
    float32, against psi_lap_residual_plain, two launches equal bit for
    bit; then CUDA-event times of both at 512 000 and 1 048 576 points
    beside the bound;
 14. K3 golden: E_int and E_lcao of those weights on the uniform n = 80 and
    the spheroidal 96 x 96 grids at R = 0.5, 1, 2, 4 (float64) equal to the
    JAX package's CPU values to 1e-10, every model quotient through K3;
 15. make ref-recipe, cut: cli train (reference-parity model, float64) and
    cli finetune for a few steps (K2 launches, and cli train's steps/s),
    then cli energy on finetune.npz at its defaults (uniform n = 80, 39 R,
    LCAO, Wind oracle; float32, as the JAX CLI scores it) and under
    --dtype float64, through the port's cli.main: each pickle's schema,
    finite errors, one K3 launch a model quotient, the two surfaces apart
    by float32 roundoff; each one's wall time and points/s, and K3's share
    of the device time in both types;
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
    sectors (K1 in float32 too), with bitwise repeats; central
    differences of psi and lap psi in x and R at 64 float64 points;
    CUDA-event times of the PG and the training launches side by side,
    beside the bound.
 The excited-state families (node factors, the |m| transverse factor,
 deflation), which K1 carries in its factor epilogue (the launch keys
 separable_fwd_ex and separable_bwd_ex); K1's ground launches run for
 ground-family references:
 18. a: E_int of the 17 shipped excited artifacts (spheroidal 96 x 96,
    float64; each config from its meta, as cli evaluate derives it) at four
    R of the artifact's own domain equal to the JAX package's CPU values to
    1e-10, one K1-fwd-ex launch a quotient and nothing else, and at R = 1
    inside each one's golden-test band against the exact oracle; b: make
    excited-2ssg through cli variational, cut in depth (--xi-node,
    deflated against the flagship, n_r 39, 40 x 24 dual grid, validation
    grid): the deflated loss finite and lower, K1-fwd launched exactly
    twice (the reference's training and validation rows), K1-bwd-ex a
    gradient and K1-fwd-ex an evaluation, target_state 2ssg in the meta,
    then torch.profiler over ten deflated evaluations; c: make
    excited-3ssg, cut (three references at 48 x 32): two K1-fwd launches
    (the flagship reference), four K1-fwd-ex ones for the excited
    references besides the model's, the references row-orthogonal to
    1e-10, target_state 3ssg; d: make excited-2ppu, cut (--m-abs 1, no
    deflation): no ground K1 launch, target_state 2ppu; e: cli evaluate
    artifacts/excited_2ssg.npz --contam-vs
    artifacts/flagship_separable.npz: the int_* and contam_* fields equal
    to the JAX CLI's to 1e-6, contamination < 1e-4, fit RMS within 0.01
    mHa, one K1-fwd launch (the reference's), K1-fwd-ex for the rest. Each
    run prints its wall time, steps/s, line-search evaluations a step and
    peak device memory beside the card's name and power limit.
 The paths across families (every family on every objective):
 19. a: cli train --arch separable at make train's batch (100 000 points,
    float32, step schedule, 300 steps after a warm-up run): steps/s, one
    K1-fwd and one K1-bwd launch a step and nothing else, the loss on a
    fixed batch lower than the init's, and that loss and its gradients
    equal to the plain versions' on the host CPU (1e-4 relative, 1e-4
    normwise); b: cli variational --arch symmetric --spheroidal at the
    flagship grid (n_r 39, 40 x 24 dual grid, validation grid, float64; 40
    Adam + 30 L-BFGS steps) from artifacts/flagship.npz (GZ + alpha) and
    from the seeded reference-parity init in both sectors: steps/s, K2
    launches and evaluations a step, peak memory; the inits' losses lower;
    on the padded batch quotient_loss and its gradients equal to the
    plain versions' (1e-10, 1e-8 normwise), the pad points moved leaving
    value and gradients bit for bit, two launches bit for bit, no
    gradient on the ungerade output bias, and torch.profiler over ten
    evaluations of the flagship's; c: the Monte-Carlo trainer at
    the CLI's defaults (32 x 32 768 = 1 048 576 importance samples a step,
    float32, --antithetic --stratified-r, 200 steps at lr 1e-3) from
    artifacts/flagship.npz (K2) and from artifacts/flagship_separable.npz
    (K1): steps/s, points/s, one forward and one backward launch a step,
    peak memory, the profiler's busy share and the kernel's share of it,
    the EMA's quotient over four fresh batches no higher than the start's
    by 3 standard errors; 10 steps of the minimal and of an R-input model
    at that batch (the plain fwdlap path: steps/s, peak memory, no launch);
    float32 K1's times at that batch (K1-bwd-pg too) beside the bound and
    the plain versions; --lbfgs 20
    (polish_lbfgs, separable, float64): evaluations a step, the objective
    on its batch not higher; d: cli train --arch
    minimal at minimal_config (10 000 points, 1 000 epochs, float32, not
    cut): steps/s, no kernel launch, the loss on a fixed batch lower, the
    trained model's cli energy --arch minimal surface finite with no
    launch; cli energy artifacts/flagship_model.bin as the reference-parity
    model (one K3 launch a model quotient) and under --arch minimal (none),
    and two seeded models (minimal; R-input, ungerade) on the 80^3 and
    spheroidal grids, E_int equal to the JAX package's CPU values to 1e-10.
 The analysis suite (cli analyze, vibrations, export, train --profile):
 20. a: cli analyze --paper-set's data (plots.paper_set_data at its
    defaults: the 39-R spheroidal surface with LCAO, 60 autograd and
    finite-difference forces and 9 Hellmann-Feynman forces, four 80^3 cubes
    for the normalisation constants and the psi and LCAO cuts, three 100 x
    100 psi surfaces, the head curves) on the card for
    flagship_separable.npz (float64), flagship.npz (float64),
    flagship_model.bin (float32, the default --dtype) and excited_2ssg.npz
    (float64), each config as cli analyze builds it: exactly 39 launches of
    the forward kernel its model quotients take (K1-fwd, K2-fwd, K3;
    K1-fwd-ex for the excited model) and nothing else; every array against
    the same from the plain path on the host CPU (on a thread, 4 torch
    threads),
    float64 to 1e-10 of its largest value, float32 to the bounds of
    ANALYZE_F32; the wall time of each part (surface, forces, probes, and
    drawing, which runs only where matplotlib imports: then the paper set
    is drawn for each and cli analyze --paper-set writes every name but
    loss_figure.pdf); torch.profiler over one paper set's data (the
    device's busy share) and the host's time to build one quotient's
    spheroidal grid; b: cli vibrations --j-max on the three rovib goldens
    (levels to 2e-9) and the J = 0 ladder of evaluated.npz (state 1ssg from
    its meta); c: cli export of flagship_separable.npz to .npz and of
    flagship_model.bin to .bin and .pt, read back bit for bit (a separable
    .bin or .pt refused), and of evaluated.npz's e_table to .csv (its 153
    knots, row for row); d: cli train --profile at 4 096 points for 5
    steps: 5 K2-fwd and 5 K2-bwd launches, both named in the Chrome trace;
    with matplotlib, cli analyze --paper-set --history from that run
    writes all of PAPER_SET_NAMES.
 Multi-device and the per-R sweep (slice 11; one card: world size 1, NCCL):
 21. a: make flagship at full length (its exact flags, 1 500 Adam + 800
    L-BFGS steps) through cli variational --mesh 1, then cli evaluate
    --steps 8000 --dtype float64 on its checkpoint: wall time, Adam and
    L-BFGS steps/s, evaluations an L-BFGS step over all 800, K1 launches,
    and E_int's mean, max and signed minimum against the exact oracle beside
    the shipped artifact's; every R within [-1e-4, 0.01] mHa, both K1
    kernels launched; b: --mesh 1 against the unsharded runs, bit for bit:
    the polish's 40 Adam losses and params at the flagship grid (the
    unsharded warmup with graph=False; --mesh stays eager), cli train at
    make train's configuration (20 steps, K2-fwd and K2-bwd each step;
    the unsharded run captured);
    rayleigh_quotient_sharded at world size 1 equal to rayleigh_quotient to
    rtol 1e-12 for flagship.npz (K2-fwd) and flagship_model.bin (K3); c:
    cli sweep --polish 300 --arch separable --dtype float64 at R = 0.5, 1,
    2, 4: each within [-1e-4, 0.01] mHa, seconds a polished R, K1
    launches; d: cli sweep, the residual family at make train's model flags
    (GZ + alpha, step schedule, float32, 100 000 points a model, M = 4 R,
    300 epochs): every model's loss finite and lower, exactly M K2-fwd and
    M K2-bwd launches a step, the family's steps/s.

 The remaining entry points (slice 12), each through its own entry point
 with the launch counts set to 0 just before it and read just after:
 22. a: cli bench at its defaults (symmetric and separable, float32,
    100 000 points, 100 steps, best of 3): the line printed, both
    families' points/s finite, 0 < peak_fraction, the FMA ceiling at most
    105% of 67 TFLOP/s, exactly 400 launches of K2-fwd, K2-bwd, K1-fwd and
    K1-bwd, K2's and K1's kernels in the profiler's rows of a short run of
    each; float32 K1 at the bench line's batch against its plain versions
    and its times (K1-bwd-pg too) beside the bound; the ceiling chains
    (csrc/ceiling.cu, built in phase 2) against their plain versions at 4
    iterations and at the bench's own shape (normwise, CEILING_FULL_TOL),
    and their rates on a line of their own;
    b: graft_entry.entry() on the card (one K1-fwd launch) against the same
    fn on the host CPU, 1e-4 relative; c: dryrun_multichip(1) (NCCL at
    world size 1; K1 and K2 launched); d: benchmarks pallas_ab (421 K3
    launches) and pallas_train_ab --model flagship and parity (100 K2-fwd
    and 100 K2-bwd each) at their defaults, their max_abs_diff and
    loss_rel_dev within the scripts' bounds, and a planted fault (the
    NN's output weights 0.1% off in the fwdlap side) above each bound; e:
    benchmarks scaling at its defaults on one card (80 K2-fwd and K2-bwd,
    the quadrature through K3); f: benchmarks dispersion at full width
    (40 x 24, 300 steps, float64) at six R for both families: every
    separable R within [-1e-4, 0.01] mHa of the exact oracle, every GZ R
    above -1e-4 mHa, the gaps printed; the figure only where matplotlib
    imports; g: benchmarks ref_recipe_score on phase 15's cut make
    ref-recipe checkpoint (39 K3 launches), its numbers equal to the same
    script's on the host CPU to 1e-9 mHa.
 bfloat16 (slice 13), each entry point with the launch counts set to 0
 just before it and read just after:
 23. a: the bfloat16 builds (storage bfloat16, float32 arithmetic, each
    output rounded once) of K1 at the flagship batch
    (flagship_separable.npz), K2 at make train's batch (flagship.npz and
    ungerade_2psu.npz) and K3 at 1 048 576 and 1 100 points with R per
    point (phase 13's weights), backward with and without point gradients:
    psi and lap psi within 4e-3 normwise of the plain version run in
    float32 on the same bfloat16-rounded inputs, within 3e-2 of the plain
    path in bfloat16 and 1.5e-2 of float64 on those inputs; every
    cotangent within 8e-3 of the float32 reference; two backward launches
    bit for bit; b: CUDA-event times of each bfloat16 build beside the
    float32 build and the plain version in bfloat16, with the bound (the
    float32 operation count at 67 TFLOP/s, half float32's bytes); c: cli
    train --dtype bfloat16 at make train's configuration (300 steps, one
    bfloat16 K2-fwd and K2-bwd a step, the loss finite and lower; steps/s
    beside the same float32 run), cli finetune of flagship.npz (no K2-bwd),
    --mesh 1 bit for bit against one device, cli train --arch separable
    (K1), the Monte-Carlo trainer from both flagship artifacts at 1 048 576
    points a step, a cut --spheroidal polish, the point gradients through
    both entry points, cli energy --dtype bfloat16 equal to --dtype float32
    bit for bit, and cli evaluate --dtype bfloat16 of
    flagship_separable.npz (K1-fwd) and of phase 15's checkpoint (K3), in
    processes of their own (the E-head fit runs on the host CPU), one
    launch a quotient.
 The captured steps (training/graphs.py), each against the same run with
 graph=False, bit for bit, the launch counts set to 0 before each run:
 24. a: engine.train at make train's configuration (GZ + alpha, step
    schedule, float32, 100 000 points), 300 steps in chunks of 100 with a
    resample every 7 steps and the frozen batch after step 270: history,
    params, best loss and params, EMA and the last batch equal, exactly
    one K2-fwd and one K2-bwd launch a step; then engine.finetune for 100
    steps (no K2-bwd); b: train_variational at the CLI's defaults (32 x
    32 768 points, float32, antithetic, stratified), 50 steps, from
    flagship_separable.npz (K1) and flagship.npz (K2); c: the flagship
    polish's Adam warmup (n_r 39, 40 x 24 dual grid, float64, 100 steps,
    K1): params and logged losses equal. Each prints its steps/s captured
    and eager from the same call, and the profiler's wall, busy time and
    idle share a step over ten steps of each.
 K1's excited-state factor epilogue (the EX instantiations):
 25. ptxas registers and spills of the EX instantiations; at make
    excited-4fpiu's batch (n_r 39, 64 x 32 dual grid: 284 310 points) the
    shipped pi_4fpiu network in float64 and float32, and at one 96 x 96
    quotient (R = 1) pi_3ppu, excited_3ssg, excited_2ssg_legacynode,
    excited_3dsg, delta_4fdu and phi_4fpu (every factor, both sectors),
    K1-fwd-ex against the plain version and K1-bwd-ex against autograd of
    it (every weight, a, b and node head) at K1's bounds, two backward
    launches bit for bit; CUDA-event times of both at the 4f pi_u batch
    beside the ground launches on the same points and the bound; then the
    4f pi_u cell's deflated Adam warmup (pi_2ppu, pi_3ppu), captured: one
    K1-fwd-ex and one K1-bwd-ex a step and nothing else, no point through
    the forward-Laplacian route.
 The R-heads kernel pair (E, alpha, b, gate at each point's R; rheads_fwd
 and rheads_bwd in K2's libraries):
 26. ptxas registers and spills (none in float32 or bfloat16) and the
    occupancy of every instantiation; at make train's batch (100 000
    points of the sampler; flagship.npz at P = +1, ungerade_2psu.npz at
    P = -1) the kernels against their plain versions: float64 values to
    rtol 1e-12, every weight gradient (normwise) and dr to 1e-8; float32
    against the float64 plain version (1e-5 values, 1e-4 gradients,
    normwise); bfloat16 against the float32 plain version on its rounded
    inputs (4e-3, 8e-3); with all four cotangents and with E's alone; two
    backward launches bit for bit; the E widths 4, 8, 16 and the
    reference-parity model (no alpha or beta head) on a ragged 1 100-point
    batch in float64; CUDA-event times of both kernels in the three types
    beside the torch heads they replace and the bound; make train captured
    against graph=False bit for bit with one rheads_fwd and one rheads_bwd
    a step beside K2's; make ref-recipe's step (float64) and its fine-tune
    with their launches a step.

``python3 chip_smoke.py --mesh N`` (a host with N >= 2 cards) runs phases
1 and 2, then the --mesh N paths across the N cards (NCCL) against the same
runs on one card: cli train (make train's model in float64, 20 steps), the
polish's Adam warmup at the flagship grid and then its sharded L-BFGS,
rayleigh_quotient_sharded, and cli sweep's family of 4 models; each
within 1e-8 (relative) of one card; then dryrun_multichip(N) and the
scaling benchmark on 1 to N cards; then cli train --dtype bfloat16 --mesh
N (its first step's loss within 2e-2 of one card's, finite and falling).

``python3 chip_smoke.py --k1-times [ROOT]`` times K1 built from the package
under ROOT (default: this checkout; a parent commit's package unpacked by
``git archive`` into a git-ignored directory of it compares two builds in
one call), as ``k1_times`` says, and prints one JSON line.

``python3 chip_smoke.py --step-times [ROOT]`` runs the trainers and the
bench line through the public entry points of the package under ROOT, as
``step_times`` says, and prints one JSON line: make train's, make
ref-recipe's, the Monte-Carlo trainer's (both families) and the Adam
warmup's steps/s, the
bench line's points/s (both families). Run it as parent, change, change,
parent in one call to compare two commits.

``python3 chip_smoke.py --k1-factors`` builds K1 and runs phase 25 alone.

``python3 chip_smoke.py --rheads`` builds K2's libraries and runs phase 26
alone.

``python3 chip_smoke.py --tracing`` measures what the port's tracing
(``utils/profiling.py``) costs on the card and checks that it changes no
step, as ``tracing_costs`` says, and prints one JSON line.

Each phase prints its wall time. Then one JSON line ``{"kernels": [...]}``,
the card line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA, and when run
from a directory that does not hold the package.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "pinn_for_quantum_wavefunction_surfaces_tpu_torch"

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W): 67
# TFLOP/s FP64 on the tensor cores, which only the H x H products can use,
# and 34 TFLOP/s FP64 outside them; 989 TFLOP/s BF16 on the tensor cores
# (again only for the products); 67 TFLOP/s FP32 outside the tensor cores;
# 3.35 TB/s of HBM3. The tensor cores and the other units are separate
# pipes that can run side by side, so a float64 or bfloat16 call takes at
# least the longer of its two shares; with the larger rate for each share,
# the bound below is a true lower bound.
PEAK_FP64_PRODUCTS, PEAK_FP64_OTHER, PEAK_FP32 = 67e12, 34e12, 67e12
PEAK_BF16_PRODUCTS = 989e12
PEAK_BYTES = 3.35e12
# the H^2 coefficient of each kernel's operation count a point: its H x H
# products (multiply-adds counted as 2 operations), all else is O(H)
PRODUCT_H2 = {("K1", "fwd"): 12, ("K1", "bwd"): 36, ("K1", "bwd_pg"): 36,
              ("K2", "fwd"): 16, ("K2", "bwd"): 48, ("K2", "bwd_pg"): 48,
              ("K3", "fwd"): 16}

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

# phase 18: the 17 shipped excited-state artifacts (artifacts/<name>.npz),
# each with the band (mHa, at R = 1) of its golden test in
# tests/test_excited.py or tests/test_pi.py against exact_energy_ode: (lo,
# hi, strict), the error in (lo, hi], or in [lo, hi] when not strict; None
# for the two extended wells, which have no such test
EXCITED_BANDS = {
    "excited_2ssg": (-1e-3, 0.05, False),
    "excited_3psu": (-1e-3, 0.06, False),
    "excited_3dsg": (-1e-3, 0.06, False),
    "excited_3ssg": (-1e-3, 0.02, False),
    "excited_4psu": (0.0, 0.09, True),
    "excited_4fsu": (0.0, 1.25, True),
    "excited_3dsg_well": None,
    "pi_2ppu": (-1e-3, 0.005, False),
    "pi_3dpg": (-1e-3, 0.03, False),
    "pi_3ppu": (-1e-3, 0.005, False),
    "pi_4dpg": (0.0, 0.20, True),
    "pi_4fpiu": (0.0, 0.65, True),
    "pi_2ppu_well": None,
    "delta_3ddg": (-1e-3, 0.05, False),
    "delta_4ddg": (0.0, 0.05, True),
    "delta_4fdu": (0.0, 0.15, True),
    "phi_4fpu": (0.0, 0.006, True),
}
# four R spread over each artifact's own R domain: the standard box's
# probes, and for the two wells ([1.5, 8] and [2.5, 8]) their own
EXCITED_PROBE_R = {"pi_2ppu_well": (1.5, 3.0, 5.0, 8.0),
                   "excited_3dsg_well": (2.5, 4.0, 6.0, 8.0)}
STANDARD_PROBE_R = (0.2, 1.0, 2.0, 4.0)


def excited_fields(meta: dict) -> tuple[dict, dict]:
    """The ModelConfig and DomainConfig fields that ``cli evaluate`` derives
    from an excited artifact's meta: the separable family, the envelope
    parity of its target_state, its m_abs, its xi_span and R domain. The
    family's factors are keyed by the params."""
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis.exact \
        import STATE_INDEX
    model = dict(arch="separable", m_abs=int(meta.get("m_abs", 0)),
                 inversion_symmetry=STATE_INDEX[meta["target_state"]][1])
    domain = {k: float(meta[k]) for k in ("xi_span", "r_lo", "r_hi")
              if k in meta}
    return model, domain


# E_int of each excited artifact at its four probe R, from the JAX package
# on the CPU in float64 (analysis.energy.rayleigh_quotient_spheroidal on
# its default 96 x 96 grid, under the config of excited_fields);
# tests/test_torch_excited.py recomputes them at each domain's two ends
JAX_EINT_EXCITED = {
    "excited_2ssg": (-0.47406013716594725, -0.36086032839601345,
                      -0.2885105995693086, -0.22177019544390494),
    "excited_3psu": (-0.22531858999752874, -0.2554058933150606,
                      -0.24510511324119108, -0.2124776307957191),
    "excited_3dsg": (-0.2226279660847834, -0.2357680372162093,
                      -0.28572219677116795, -0.29850097178349644),
    "excited_3ssg": (-0.21444337857598142, -0.17767572525002512,
                      -0.1509795995403749, -0.12206033852248155),
    "excited_4psu": (-0.12623742653358472, -0.13728795023758733,
                      -0.13127789779810772, -0.11535102623282067),
    "excited_4fsu": (-0.12393406731183285, -0.1262175784971314,
                      -0.13233604303247326, -0.1666571365671471),
    "excited_3dsg_well": (-0.30601009890603614, -0.298510772993038,
                           -0.24866211042799302, -0.2112483400450479),
    "pi_2ppu": (-0.49496274478097474, -0.4287712129164199,
                 -0.3508240633643462, -0.2595090533287741),
    "pi_3dpg": (-0.22242108482852263, -0.22669281742188754,
                 -0.2309514385419327, -0.21938832714132142),
    "pi_3ppu": (-0.22073436567625557, -0.20086423219172744,
                 -0.17554995635669135, -0.14125943344936143),
    "pi_4dpg": (-0.12492097058205168, -0.12661548084775368,
                 -0.12721826829167313, -0.11963947141846461),
    "pi_4fpiu": (-0.12444153564922147, -0.12588056330864986,
                  -0.12964020115424307, -0.13934910049342042),
    "pi_2ppu_well": (-0.38644362064013493, -0.29699128728264973,
                      -0.23271589041066942, -0.18875198449549085),
    "delta_3ddg": (-0.2217691868246612, -0.2127317757775241,
                    -0.1944412573924212, -0.16071963043676002),
    "delta_4ddg": (-0.12481084380142594, -0.12101800128402938,
                    -0.11329248945471952, -0.0983540765956795),
    "delta_4fdu": (-0.12489172516041076, -0.12490908961970458,
                    -0.12447635831366358, -0.12069306091147428),
    "phi_4fpu": (-0.12492060446112922, -0.1231251351265029,
                  -0.11846016630046383, -0.1064943381868008),
}

# the cut excited recipes of phase 18 (make excited-2ssg, -3ssg, -2ppu):
# Adam and L-BFGS steps, and the 3ssg cut's grid
EXC_ADAM_STEPS, EXC_LBFGS_STEPS = 40, 30
EXC3_N_XI, EXC3_N_ETA, EXC3_STEPS = 48, 32, 3
# the JAX CLI's int_* and contam_* fields of `cli evaluate
# artifacts/excited_2ssg.npz --dtype float64 --target-state 2ssg
# --contam-vs artifacts/flagship_separable.npz` on the CPU;
# tests/test_torch_excited.py recomputes the contamination
JAX_EVAL_2SSG = {"int_mean_err_mHa": 0.0055, "int_max_err_mHa": 0.0392,
                 "int_min_signed_mHa": 0.0024,
                 "contam_max_frac": 6.060783508324873e-08,
                 "contam_mean_frac": 2.157343158053493e-08}


K3_SEED = 2024
# the gate widths of K3's checks beside the paper's 10: the least and the
# most the kernel takes (pallas_residual.MAX_HIDDEN_GATE)
K3_GATE_WIDTHS = (1, 10, 256)
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


def k3_weights(h: int = 16, hg: int = 10, gate_scale: float = 1.0) -> dict:
    """Reference-parity symmetric params (by default at the paper widths:
    correction MLP 2 -> 16 -> 16 -> 1, gate 1 -> 10 -> 1; the E head
    1 -> 32 -> 32 -> 1) in the JAX layout of numpy arrays, drawn from numpy's
    default_rng(K3_SEED):
    each layer U(+-s/sqrt(fan_in)) as torch.nn.Linear draws with s = 1,
    except s = 4 for the first layer, s = 8 for the correction's output
    layer and s = gate_scale for the gate's, so that the correction is a
    sizeable share of psi (a gate of 256 units needs gate_scale 4). The output
    bias cancels the branches' value far from the nuclei (where both
    envelopes vanish), so the gerade correction decays as psi does."""
    import numpy as np
    p = seeded_weights(K3_SEED, 2, h, hg, gate_scale)

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    far = sig(sig(p["h1"]["b"]) @ p["h2"]["w"] + p["h2"]["b"]) \
        @ p["out"]["w"][:, 0]
    p["out"]["b"] = np.array([-2.0 * far])
    return p


def seeded_weights(seed: int, n_in: int = 2, h: int = 16, hg: int = 10,
                   gate_scale: float = 1.0) -> dict:
    """The symmetric tree (h1 with n_in input rows) in the JAX layout of
    numpy arrays, drawn from numpy's default_rng(seed): each layer
    U(+-s/sqrt(fan_in)) as torch.nn.Linear draws with s = 1, except s = 4
    for the first layer, s = 8 for the correction's output layer and s =
    gate_scale for the gate's."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def lin(d_in, d_out, s=1.0):
        bound = s / np.sqrt(d_in)
        return {"w": rng.uniform(-bound, bound, (d_in, d_out)),
                "b": rng.uniform(-bound, bound, (d_out,))}

    return {"h1": lin(n_in, h, 4.0), "h2": lin(h, h), "out": lin(h, 1, 8.0),
            "e1": lin(1, 32), "e2": lin(32, 32), "eout": lin(32, 1),
            "gate1": lin(1, hg), "gate2": lin(hg, 1, gate_scale)}


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
    operations at the peak rates of their type. In float64 and bfloat16
    the H x H products (PRODUCT_H2 H^2 a point) run at the type's
    tensor-core rate and the rest at the rate outside the tensor cores
    (FP32's for bfloat16), the two side by side (the longer share bounds
    the call); float32 counts every operation at its one rate. which:
    "fwd", "bwd", or "bwd_pg" (the backward with point gradients: dx, dy, dz, dr out)."""
    size = {"float64": 8, "float32": 4, "bfloat16": 2}[dtype]
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
    if dtype == "float32":
        t_ops = ops / PEAK_FP32
    else:
        products = n * PRODUCT_H2[(kernel, which)] * h * h
        on_tc, off_tc = {"float64": (PEAK_FP64_PRODUCTS, PEAK_FP64_OTHER),
                         "bfloat16": (PEAK_BF16_PRODUCTS, PEAK_FP32)}[dtype]
        t_ops = max(products / on_tc, (ops - products) / off_tc)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


# the weight-gradient names of K1's and K2's backward outputs, in order
K1_GRADS = ["lam1/w", "lam1/b", "lam2/w", "lam2/b", "lamout/w", "lamout/b",
            "mu1/w", "mu1/b", "mu2/w", "mu2/b", "muout/w", "muout/b", "a",
            "b"]
K2_GRADS = ["h1/w", "h1/b", "h2/w", "h2/b", "out/w", "out/b", "a", "b", "g"]


def k1_f32_bounds(psi_p, lap_p):
    """K1's float32 bounds against its plain version: ((rtol, atol) of
    psi, of lap psi, normwise bound of the backward). Unit roundoff 6e-8;
    psi passes ~2H + 10 roundings and exp of O(3) arguments; lap cancels
    terms up to ~2a/r1 (~1e3 |lap| near the nuclei), so it gets an absolute
    floor at its own scale; the gradients sum the points in another
    order."""
    return ((1e-5, 1e-7 * float(psi_p.abs().max())),
            (1e-4, 1e-5 * float(lap_p.abs().max())), 1e-4)


def k2_f32_bounds(psi_p, lap_p):
    """K2's float32 bounds, as ``k1_f32_bounds``: psi sums the gated
    network and the GZ pair (O(1) terms that cancel in the ungerade
    sector), so its absolute floor is set by max |psi|; lap cancels terms
    up to ~2a/r1 near the nuclei; the weight gradients sum the points in
    another order, and in the ungerade sector the two branches cancel."""
    return ((1e-4, 4e-6 * float(psi_p.abs().max())),
            (1e-3, 1e-5 * float(lap_p.abs().max())), 5e-4)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# The bool template parameters (after the type and the width) of each
# library's kernels, in order; the other libraries' kernels have none.
KERNEL_FLAGS = {"separable_fwd": ("ex",), "separable_bwd": ("pg", "ex"),
                "train_bwd": ("pg",)}


def ptxas_entries(name: str, log: str) -> list[dict]:
    """One entry per kernel instantiation of library ``name``'s nvcc
    -Xptxas -v log: its kernel's name, type and width (pg: a backward
    kernel's point-gradient instantiation; ex: K1's excited-state factor
    instantiation; the flags as KERNEL_FLAGS names them), registers, spill
    stores and loads (bytes), and ptxas's stack and spill line. The R-heads
    kernels (rheads_*_kernel, in K2's libraries) have no flags."""
    out, inst, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'.*\d([A-Za-z_]\w*_kernel)I(d|f|13__nv_bfloat16)"
                      r"Li(\d+)E((?:Lb[01]E)*)", line)
        if m:
            flags = [f == "1" for f in re.findall(r"Lb([01])E", m.group(4))]
            inst = dict(kernel=m.group(1), dtype={
                "d": "float64", "f": "float32"}.get(m.group(2), "bfloat16"),
                h=int(m.group(3)), pg=False, ex=False)
            if not inst["kernel"].startswith("rheads"):
                inst.update(zip(KERNEL_FLAGS.get(name, ()), flags))
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and inst:
            stores = re.search(r"(\d+) bytes spill stores", spill)
            loads = re.search(r"(\d+) bytes spill loads", spill)
            out.append(dict(
                inst, spill=spill,
                registers=int(re.search(r"Used (\d+) registers",
                                        line).group(1)),
                spill_stores=int(stores.group(1)) if stores else 0,
                spill_loads=int(loads.group(1)) if loads else 0))
            inst = None
    return out


def ptxas_summary(name: str, log: str) -> list[str]:
    """One line per kernel instantiation of library ``name``'s nvcc
    -Xptxas -v log (see ptxas_entries)."""
    return [f"{'rheads ' if e['kernel'].startswith('rheads') else ''}"
            f"{e['dtype']} H={e['h']}{' PG' if e['pg'] else ''}"
            f"{' EX' if e['ex'] else ''}: "
            f"{e['registers']} registers; {e['spill']}"
            for e in ptxas_entries(name, log)]


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
    names = K2_GRADS
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
                tol_psi, tol_lap, tol_bwd = k2_f32_bounds(psi_p, lap_p)
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
# phase 13's ragged batch: neither a multiple of a float64 tile (32 or 16
# points) nor of a float32 block (128)
K3_N_RAGGED, K3_WIDTH_GATE_SCALE = 1100, 4.0
REF_TRAIN_STEPS, REF_FINETUNE_STEPS = 200, 100
# the seed of cli train's config, named in the kept checkpoint's run
REF_SEED = 12345
# files one phase leaves to a later one (removed at the end of the run)
KEEP_DIR = os.path.join(tempfile.gettempdir(),
                        f"chip_smoke_keep_{os.getpid()}")


def k3_term_sizes(kt, ws, x, y, z, r, *, p_sym, ry, rz):
    """The largest sums of |terms| that K3's psi and lap psi add at a point
    (so the scale of their float32 roundoff): |g| (|ob| + |b+| + |b-|) +
    e^{-r1} + e^{-r2}, and |g| (|lap b+| + |lap b-|) + |l1| + |l2|, from the
    plain version's parts (ops/pallas_train.py)."""
    import torch
    gw1, gb1, gw2, gb2 = ws[6:]
    g = ((torch.sigmoid(r[:, None] @ gw1 + gb1) @ gw2 + gb2)[:, 0]).abs()
    one = torch.ones_like(x)
    ep = kt._envelopes(x, y, z, r, one, ry, rz, False)
    vp, lp, _, _ = kt._branch_fwd(ws[:6], ep)
    vm, lm, _, _ = kt._branch_fwd(
        ws[:6], kt._envelopes(x, y, z, r, one, ry, rz, True))
    sv = g * (ws[5][0, 0].abs() + vp.abs() + vm.abs()) + ep["f1"] + ep["f2"]
    sl = g * (lp.abs() + lm.abs()) + ep["l1"].abs() + ep["l2"].abs()
    return float(sv.max()), float(sl.max())


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
          f"{K3_N_UNIFORM} uniform points at R = 2 and at R per point; "
          f"H = 4..32, gate {K3_GATE_WIDTHS[0]} and {K3_GATE_WIDTHS[-1]} on "
          f"{K3_N_RAGGED} points)")
    ax = np.linspace(-18.0, 18.0, K3_GRID_N)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    rng = np.random.default_rng(K3_SEED)
    uniform = [rng.uniform(-18.0, 18.0, K3_N_UNIFORM) for _ in range(3)]
    # R per point: the gate varies within every tile and every block
    r_uniform = rng.uniform(0.2, 4.0, K3_N_UNIFORM)
    ragged = [rng.uniform(-6.0, 6.0, K3_N_RAGGED) for _ in range(3)]
    r_ragged = rng.uniform(0.2, 4.0, K3_N_RAGGED)
    point_sets = {
        "grid": ([a.ravel() for a in (gx, gy, gz)], 1.0),
        "uniform": (uniform, 2.0),
        "uniform R per point": (uniform, r_uniform),
        f"ragged {K3_N_RAGGED} R per point": (ragged, r_ragged),
    }
    # (point set, widths (H, Hg), P, ry, rz): the paper widths' weights, and
    # at every width the kernel is built for with the least and the most
    # gate units, weights whose gate's output layer is drawn wider so that a
    # 256-unit gate is O(1) (their correction is 0.85% of psi or more)
    cases = [("grid", (h, hg), 1, 0.0, 0.0), ("grid", (h, hg), -1, 0.0, 0.0),
             ("uniform", (h, hg), 1, 0.0, 0.0),
             ("uniform", (h, hg), -1, 0.0, 0.0),
             ("uniform", (h, hg), 1, 0.3, -0.2),
             ("uniform R per point", (h, hg), 1, 0.0, 0.0),
             ("uniform R per point", (h, hg), -1, 0.0, 0.0)]
    widths = [(h, hg)] + [(hh, gg) for hh in k3.SUPPORTED_HIDDEN
                          for gg in (K3_GATE_WIDTHS[0], K3_GATE_WIDTHS[-1])]
    cases += [(f"ragged {K3_N_RAGGED} R per point", hw, p_sym, 0.0, 0.0)
              for hw in widths for p_sym in (1, -1)]
    errs, inputs = {}, {}
    for dt_name, dt in (("float64", torch.float64),
                        ("float32", torch.float32)):
        worst = 0.0
        for label, (hh, gg), p_sym, ry, rz in cases:
            paper = (hh, gg) == (h, hg)
            tree = (weights if paper
                    else k3_weights(hh, gg, K3_WIDTH_GATE_SCALE))
            params = ansatz.from_jax_params(tree, dtype=dt, device=dev)
            arrays, ri = point_sets[label]
            pts = [torch.as_tensor(a, dtype=dt, device=dev) for a in arrays]
            r = (torch.full_like(pts[0], ri) if np.isscalar(ri)
                 else torch.as_tensor(ri, dtype=dt, device=dev))
            mcfg = config.ModelConfig(inversion_symmetry=p_sym, ry=ry, rz=rz,
                                      hidden=hh)
            ws = k3.kernel_weights(params, mcfg, dt)
            kw = dict(p_sym=p_sym, ry=ry, rz=rz)
            psi_k, lap_k = k3.residual_fwd_cuda(ws, *pts, r, **kw)
            psi_2, lap_2 = k3.residual_fwd_cuda(ws, *pts, r, **kw)
            with torch.no_grad():
                psi_p, lap_p = k3.psi_lap_residual_plain(ws, *pts, r, **kw)
                lcao, _ = energy.lcao_fwdlap(mcfg, *pts, r)
            torch.cuda.synchronize()
            name = (f"K3 {label} H={hh} Hg={gg} P={p_sym} ry={ry} rz={rz} "
                    f"{dt_name}")
            if not (torch.equal(psi_k, psi_2) and torch.equal(lap_k, lap_2)):
                raise AssertionError(f"{name}: two launches differ")
            share = float((psi_p - lcao).abs().max() / psi_p.abs().max())
            if not share >= (1e-2 if paper else 5e-3):
                raise AssertionError(f"{name}: the correction is "
                                     f"{share:.2e} of psi; it must be a "
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
                if not paper:
                    # the other widths' draws (output layer and gate drawn
                    # wide) sum branch terms larger than psi itself: the
                    # floor is set by the size of those terms
                    with torch.no_grad():
                        sv, sl = k3_term_sizes(kt, ws, *pts, r, **kw)
                    tol_psi = (1e-4, 4e-6 * sv)
                    tol_lap = (1e-3, 1e-5 * sl)
            e_psi = check_close(name + " psi", psi_k, psi_p, *tol_psi)
            e_lap = check_close(name + " lap", lap_k, lap_p, *tol_lap)
            print(f"{name}: psi max abs {e_psi[0]:.3e} | lap max abs "
                  f"{e_lap[0]:.3e} rel {e_lap[1]:.3e} | correction share "
                  f"{share:.3f} | two launches bitwise equal")
            worst = max(worst, e_psi[0], e_lap[0])
            if label in ("grid", "uniform") and ry == 0.0 and p_sym == 1:
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
          "defaults and under --dtype float64")
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
        # phase 22g scores this checkpoint with ref_recipe_score
        keep = os.path.join(KEEP_DIR, "ref_recipe", f"s{REF_SEED}", "stage2")
        os.makedirs(keep, exist_ok=True)
        shutil.copy(ft, keep)
        n_r = len(np.round(np.arange(0.2, 4.0 + 0.1, 0.1), 2))
        per = K3_GRID_N * K3_GRID_N
        want_launches = n_r * -(-K3_GRID_N // max(1, energy.CHUNK_POINTS
                                                  // per))
        pts_model = n_r * K3_GRID_N ** 3
        surfs, energy_runs = {}, {}
        # at its defaults cli energy scores a float64 checkpoint in float32
        # (the JAX CLI's rule); --dtype float64 keeps the checkpoint's type
        for dt_name, flags in (("float32", []),
                               ("float64", ["--dtype", "float64"])):
            pkl = os.path.join(work, f"energy_R_ion_{dt_name}.pkl")
            k3.reset_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            summary, _ = run_cli(["energy", ft, "--out", pkl] + flags)
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = dict(k3.launches)
            surf = energy.load_surface(pkl)
            if sorted(surf) != ["E_int", "E_net", "Elcao", "R"] or any(
                    len(v) != n_r for v in surf.values()):
                raise AssertionError(
                    f"the surface pickle's schema: "
                    f"{ {k: np.shape(v) for k, v in surf.items()} }")
            if not all(np.all(np.isfinite(v)) for v in surf.values()) or \
                    not all(np.isfinite([summary["max_err_mHa"],
                                         summary["mean_err_mHa"]])):
                raise AssertionError("the surface or its errors are not "
                                     "finite")
            if counts["residual_fwd"] != want_launches:
                raise AssertionError(f"cli energy ({dt_name}) launched K3 "
                                     f"{counts['residual_fwd']} times, the "
                                     f"chunking implies {want_launches}")
            surfs[dt_name] = surf
            energy_runs[dt_name] = dict(wall=wall,
                                        launches=counts["residual_fwd"])
            print(f"cli energy ({dt_name}): {n_r} R in {wall:.3f} s, "
                  f"{pts_model / wall:.4e} model points/s "
                  f"({2 * pts_model / wall:.4e} with the LCAO quotients); "
                  f"K3 launches {counts}; E_int at R=1 "
                  f"{surf['E_int'][8]:.9f}, E_lcao {surf['Elcao'][8]:.9f}, "
                  f"E_net {surf['E_net'][8]:.9f}")
        # float32 quotients of 512 000 points agree with float64 to ~1e-6
        # relative; no difference at all would mean the default run did not
        # score in float32
        diff = {k: float(np.abs(surfs["float32"][k]
                                - surfs["float64"][k]).max())
                for k in ("E_int", "Elcao", "E_net")}
        print(f"cli energy float32 against float64: max |diff| {diff}")
        if not all(0.0 < d < 1e-4 for d in diff.values()):
            raise AssertionError(f"the float32 surface against the float64 "
                                 f"one: {diff}")
        tree_ft = _load_npz_params(ft)
        for dt_name in ("float64", "float32"):
            params_ft = ansatz.from_jax_params(tree_ft, dtype=dt_name,
                                               device=dev)
            cfg_ft = config.Config(dtype=dt_name)
            _, busy, by_kernel = profile_device(
                lambda: energy.surface(params_ft, cfg_ft,
                                       r_values=[1.0, 2.0, 3.0]), 1,
                f"surface of 3 R in {dt_name} (model and LCAO quotients)")
            k3_ms = sum(v for k, v in by_kernel.items()
                        if "GateSource" in k or "residual_fwd" in k)
            print(f"K3's share of the device time ({dt_name}): "
                  f"{k3_ms / busy:.4f} ({k3_ms:.4f} of {busy:.4f} ms)",
                  flush=True)

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
            "one K1-fwd launch a quotient": _nonzero(ev_counts) == {
                "separable_fwd": n_quot},
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"make evaluate: {failed}")
        sys.stdout.flush()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    t32, t64 = (times[(dt_name, K3_GRID_N ** 3)]
                for dt_name in ("float32", "float64"))
    return {
        "name": "residual_fwd",
        "route": "cuda",
        "source": f"{PKG}/csrc/residual_fwd.cu",
        "replaces": ("pinn_for_quantum_wavefunction_surfaces_tpu/ops/"
                     "pallas_residual.py:200"),
        "launches": energy_runs["float32"]["launches"],
        "dtype": "float32",
        "max_abs_err": errs["float32"],
        "ms": t32["ms"],
        "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"],
        "bound_by": t32["bound_by"],
        "library_ms": None,
        "float64": {"launches": energy_runs["float64"]["launches"],
                    "max_abs_err": errs["float64"],
                    "ms": t64["ms"],
                    "plain_ms": t64["plain_ms"],
                    "bound_ms": t64["bound_ms"],
                    "bound_by": t64["bound_by"]},
    }


# phase 17: the slice of the path held against the CPU, and the central
# differences' points and step
PG_CPU_POINTS, PG_FD_POINTS, PG_FD_H = 4096, 64, 1e-5


def pg_check(kind, label, ws, args, kw, gen, tol_w, tol_p):
    """A PG = true launch of K1-bwd or K2-bwd against the plain point_grads
    VJP (every output normwise: the weight gradients and da, db (dg) to
    tol_w, dx..dr to tol_p), and two PG launches bit for bit; the weight
    gradients' largest normwise difference to the training launch's is
    printed. Returns (worst abs, worst normwise) over all outputs.

    The plain VJP runs in float64 on the same inputs (float32 ones cast
    up), and both cotangents come from ``gen``: the ungerade weight
    gradients are sums of cancelling terms, whose float32 roundoff alone
    varies from 3e-5 to 3e-4 normwise with the draw, in the plain VJP as
    in the kernel, so a float32 reference put up to twice that error on
    the kernel."""
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
    dpsi, dlap = (torch.randn(n, generator=gen, device=args[0].device,
                              dtype=args[0].dtype) for _ in range(2))

    def flat(out):
        return list(out[0]) + list(out[1:])

    def f64(ts):
        return [t.to(torch.float64) for t in ts]

    got = flat(bwd(ws, *args, dpsi, dlap, point_grads=True, **kw))
    again = flat(bwd(ws, *args, dpsi, dlap, point_grads=True, **kw))
    off = flat(bwd(ws, *args, dpsi, dlap, **kw))
    with torch.no_grad():
        want = flat(vjp(f64(ws), *f64(args), *f64((dpsi, dlap)),
                        point_grads=True, **kw))
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
    if _nonzero(counts) != {"separable_fwd": n_k1, "separable_bwd_pg": n_k1,
                            "train_fwd": len(cases) - n_k1,
                            "train_bwd_pg": len(cases) - n_k1}:
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
                if kind == "K1":
                    # float32's one-thread-a-point kernels are instantiated
                    # per width: the same points and weights rounded once
                    f32 = [t.float() for t in ws], [t.float() for t in args]
                    pg_check(kind, f"H={h} P={p_sym} n={n} float32", *f32,
                             dict(p_sym=p_sym), gen, 1e-4, 1e-4)
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


def excited_polish(label, flags, loss_name, card, work, ks=None):
    """One cut polish recipe through ``cli variational`` on the card: its
    wall time, Adam and L-BFGS steps/s (the Adam phase ends when the CLI
    writes warmup.npz), training evaluations of ``loss_name`` (those under
    autograd, the validation grid's run without: the Adam steps, one an
    evaluation, and the L-BFGS line search's, counted), the launches of the
    kernel module ``ks`` (default K1's) and peak device memory of the run,
    its meta and params."""
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
        checkpoint
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        variational
    if ks is None:
        from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
            pallas_separable as ks
    adam = int(flags[flags.index("--adam-warmup") + 1])
    lbfgs = int(flags[flags.index("--lbfgs") + 1])
    out_dir = os.path.join(work, label)
    real, evals = getattr(variational, loss_name), [0]
    real_adam, in_adam = variational._adam_minimize, [False]

    def counted(*a, **k):
        # a captured Adam warmup calls its loss at its first step and at
        # its capture only: its evaluations are its steps, counted below
        if torch.is_grad_enabled() and not in_adam[0]:
            evals[0] += 1
        return real(*a, **k)

    def adam_minimize(*a, **k):
        in_adam[0] = True
        try:
            return real_adam(*a, **k)
        finally:
            in_adam[0] = False

    setattr(variational, loss_name, counted)
    variational._adam_minimize = adam_minimize
    try:
        ks.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        res, _ = run_cli(["variational", "--out", out_dir, "--device",
                          "cuda"] + flags)
        torch.cuda.synchronize()
        t1 = time.time()
    finally:
        setattr(variational, loss_name, real)
        variational._adam_minimize = real_adam
    evals[0] += adam
    counts = dict(ks.launches)
    peak = torch.cuda.max_memory_allocated()
    t_adam = os.path.getmtime(os.path.join(out_dir, "warmup.npz")) - t0
    per_step = (evals[0] - adam) / lbfgs
    print(f"{label}: {t1 - t0:.2f} s wall; Adam {adam / t_adam:.2f} "
          f"steps/s, L-BFGS {lbfgs / (t1 - t0 - t_adam):.2f} steps/s; "
          f"{per_step:.2f} evaluations per L-BFGS step (its line search's; "
          f"the first step evaluates its start too); launches {counts}; "
          f"peak device memory "
          f"{peak / 2 ** 30:.3f} GiB ({card})", flush=True)
    path = os.path.join(out_dir, "variational.npz")
    return {"res": res, "counts": counts, "meta": checkpoint.load_meta(path),
            "params": _load_npz_params(path), "evals": evals[0],
            "wall": t1 - t0, "t_adam": t_adam, "peak": peak}


def _excited_counts(counts: dict, ground: int, references: int) -> bool:
    """Whether an excited polish's K1 launches are as its route has them:
    ``ground`` ground launches (K1-fwd for ground-family references), and
    through the factor epilogue the model's own evaluations (K1-fwd-ex
    beside each K1-bwd-ex: the validation grid's forward has no backward)
    besides ``references`` forward launches of excited references."""
    got = _nonzero(counts)
    return (got.get("separable_fwd", 0) == ground and
            set(got) <= {"separable_fwd", "separable_fwd_ex",
                         "separable_bwd_ex"} and
            got.get("separable_bwd_ex", 0) > 0 and
            got.get("separable_fwd_ex", 0) >= references +
            got["separable_bwd_ex"])


def excited_phase(dev, card: str) -> None:
    """Phase 18: the excited-state families on the card. K1 carries their
    factors in its factor epilogue (the launch keys separable_fwd_ex and
    separable_bwd_ex); K1's ground launches run for ground-family
    references."""
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
        pallas_separable as ks
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        variational

    art = os.path.join(HERE, "artifacts")
    flagship = os.path.join(art, "flagship_separable.npz")

    def exc_cfg(**model):
        return config.Config(model=config.ModelConfig(arch="separable",
                                                      **model),
                             dtype="float64")

    phase("18a excited goldens (17 shipped artifacts, E_int on the 96 x 96 "
          "spheroidal grid, float64)")
    ks.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    worst, e_one = 0.0, {}
    for name, gold in JAX_EINT_EXCITED.items():
        path = os.path.join(art, name + ".npz")
        meta = checkpoint.load_meta(path)
        model, domain = excited_fields(meta)
        cfg = config.Config(model=config.ModelConfig(**model),
                            domain=config.DomainConfig(**domain),
                            dtype="float64")
        params = ansatz.from_jax_params(_load_npz_params(path),
                                        dtype="float64", device=dev)
        got = [energy.rayleigh_quotient_spheroidal(params, cfg, float(ri))
               for ri in EXCITED_PROBE_R.get(name, STANDARD_PROBE_R)]
        rel = np.abs(np.array(got) - gold) / np.abs(gold)
        worst = max(worst, float(rel.max()))
        if not rel.max() <= 1e-10:
            raise AssertionError(f"{name}: E_int {got} against JAX {gold} "
                                 f"(rel {rel.max():.3e})")
        if EXCITED_BANDS[name] is not None:
            e_one[name] = (meta["target_state"], got[1])
    t_gold = time.time() - t0
    counts = dict(ks.launches)
    n_quot = sum(len(EXCITED_PROBE_R.get(name, STANDARD_PROBE_R))
                 for name in JAX_EINT_EXCITED)
    print(f"{n_quot} quotients equal to the JAX package's to {worst:.3e} "
          f"relative (bound 1e-10); K1 launches {counts}; {t_gold:.2f} s; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({card})")
    if _nonzero(counts) != {"separable_fwd_ex": n_quot}:
        raise AssertionError(f"the excited quotients' K1 launches: "
                             f"{counts}")
    t0 = time.time()
    for name, (state, e) in e_one.items():
        lo, hi, strict = EXCITED_BANDS[name]
        err = 1e3 * (e - float(energy.exact_energy_ode([1.0], state)[0]))
        print(f"  {name} at R = 1: {err:+.6f} mHa against the exact "
              f"{state} (band {lo}, {hi})")
        if not ((lo < err if strict else lo <= err) and err <= hi):
            raise AssertionError(f"{name}: {err} mHa outside its band")
    print(f"the oracle at R = 1 for {len(e_one)} states: "
          f"{time.time() - t0:.2f} s (host)", flush=True)

    work = tempfile.mkdtemp(prefix="chip_smoke_excited_")
    try:
        # warm-up outside the counted and timed runs (lazy imports and
        # module loading on the fwdlap and deflation paths)
        variational.polish_spheroidal(
            None, exc_cfg(xi_node=True), n_r=2, n_xi=8, n_eta=6, steps=2,
            adam_steps=2, deflate_params=_load_npz_params(flagship),
            device=dev)
        grid = ["--n-r", str(N_R), "--dtype", "float64", "--spheroidal"]

        phase(f"18b make excited-2ssg, cut ({EXC_ADAM_STEPS} + "
              f"{EXC_LBFGS_STEPS} steps, n_r {N_R}, {N_XI} x {N_ETA} dual "
              "grid and validation grid, float64)")
        flags = ["--arch", "separable", "--xi-node", "--deflate", flagship,
                 "--adam-warmup", str(EXC_ADAM_STEPS), "--lbfgs",
                 str(EXC_LBFGS_STEPS), "--lbfgs-memory", "50", "--n-xi",
                 str(N_XI), "--n-eta", str(N_ETA)] + grid
        run = excited_polish("excited-2ssg", flags, "quotient_loss_deflated",
                             card, work)
        cfg = exc_cfg(xi_node=True)
        vb = variational.dual_grid_vbatch(cfg, N_R, N_XI, N_ETA, device=dev)
        ref = [ansatz.from_jax_params(_load_npz_params(flagship),
                                      dtype="float64", device=dev)]
        psi0, hpsi0 = variational.reference_states_on_batch(ref, cfg, vb)
        init = ansatz.init_params(cfg.model, seed=cfg.train.seed,
                                  dtype="float64", device=dev)
        out = ansatz.from_jax_params(run["params"], device=dev)
        with torch.no_grad():
            loss0, loss1 = (float(variational.quotient_loss_deflated(
                p, cfg, vb, psi0, hpsi0)[0]) for p in (init, out))
        print(f"deflated loss {loss0:.9f} -> {loss1:.9f}; meta "
              f"{run['meta']}")
        if not (np.isfinite(loss1) and loss1 < loss0):
            raise AssertionError(f"2ssg loss: {loss0} -> {loss1}")
        if not _excited_counts(run["counts"], 2, 0):
            raise AssertionError(f"2ssg K1 launches: {run['counts']}")
        if run["meta"].get("target_state") != "2ssg" or \
                not run["res"]["deflated"]:
            raise AssertionError(f"2ssg meta: {run['meta']}")
        prof = {k: {f: t.detach().clone().requires_grad_(True)
                    for f, t in v.items()} for k, v in init.items()}

        def deflated_eval():
            variational.quotient_loss_deflated(prof, cfg, vb, psi0,
                                               hpsi0)[0].backward()

        for _ in range(3):
            deflated_eval()
        wall_ms, busy_ms, _ = profile_device(
            deflated_eval, 10, "deflated evaluation (fwdlap, 164 502 "
            "points)")
        print(f"device busy share {busy_ms / wall_ms:.4f} of 10 deflated "
              f"evaluations ({card})", flush=True)

        phase(f"18c make excited-3ssg, cut ({EXC3_STEPS} + {EXC3_STEPS} "
              f"steps, {EXC3_N_XI} x {EXC3_N_ETA}, three references)")
        refs3 = [flagship] + [os.path.join(art, n + ".npz")
                              for n in ("excited_2ssg", "excited_3dsg")]
        flags = ["--arch", "separable", "--xi-node2", "--wide-alpha",
                 "--adam-warmup", str(EXC3_STEPS), "--lbfgs",
                 str(EXC3_STEPS), "--lbfgs-memory", "50", "--n-xi",
                 str(EXC3_N_XI), "--n-eta", str(EXC3_N_ETA)] + grid
        for path in refs3:
            flags += ["--deflate", path]
        run = excited_polish("excited-3ssg", flags, "quotient_loss_deflated",
                             card, work)
        cfg = exc_cfg(xi_node=True, xi_node2=True, wide_alpha=True)
        vb = variational.dual_grid_vbatch(cfg, N_R, EXC3_N_XI, EXC3_N_ETA,
                                          device=dev)
        ps, hs = variational.reference_states_on_batch(
            [ansatz.from_jax_params(_load_npz_params(p), dtype="float64",
                                    device=dev) for p in refs3], cfg, vb)
        cross = max(float((torch.sum(vb.w * ps[i] * ps[j], dim=1)
                           / torch.sqrt(torch.sum(vb.w * ps[i] ** 2, dim=1)
                                        * torch.sum(vb.w * ps[j] ** 2,
                                                    dim=1))).abs().max())
                    for i in range(3) for j in range(i))
        init = ansatz.init_params(cfg.model, seed=cfg.train.seed,
                                  dtype="float64", device=dev)
        out = ansatz.from_jax_params(run["params"], device=dev)
        with torch.no_grad():
            loss0, loss1 = (float(variational.quotient_loss_deflated(
                p, cfg, vb, ps, hs)[0]) for p in (init, out))
        print(f"deflated loss {loss0:.9f} -> {loss1:.9f}; references "
              f"row-orthogonal to {cross:.3e}; meta {run['meta']}")
        if not (np.isfinite(loss1) and loss1 < loss0):
            raise AssertionError(f"3ssg loss: {loss0} -> {loss1}")
        if cross > 1e-10:
            raise AssertionError(f"3ssg references: cross {cross}")
        if not _excited_counts(run["counts"], 2, 4):
            raise AssertionError(f"3ssg K1 launches: {run['counts']}")
        if run["meta"].get("target_state") != "3ssg":
            raise AssertionError(f"3ssg meta: {run['meta']}")

        phase(f"18d make excited-2ppu, cut ({EXC_ADAM_STEPS} + "
              f"{EXC_LBFGS_STEPS} steps, m_abs 1, no deflation)")
        flags = ["--arch", "separable", "--m-abs", "1", "--wide-alpha",
                 "--adam-warmup", str(EXC_ADAM_STEPS), "--lbfgs",
                 str(EXC_LBFGS_STEPS), "--n-xi", str(N_XI), "--n-eta",
                 str(N_ETA)] + grid
        run = excited_polish("excited-2ppu", flags, "quotient_loss", card,
                             work)
        cfg = exc_cfg(m_abs=1, wide_alpha=True)
        vb = variational.dual_grid_vbatch(cfg, N_R, N_XI, N_ETA, device=dev)
        init = ansatz.init_params(cfg.model, seed=cfg.train.seed,
                                  dtype="float64", device=dev)
        out = ansatz.from_jax_params(run["params"], device=dev)
        with torch.no_grad():
            loss0, loss1 = (float(variational.quotient_loss(p, cfg, vb)[0])
                            for p in (init, out))
        print(f"loss {loss0:.9f} -> {loss1:.9f}; meta {run['meta']}")
        if not (np.isfinite(loss1) and loss1 < loss0):
            raise AssertionError(f"2ppu loss: {loss0} -> {loss1}")
        if not _excited_counts(run["counts"], 0, 0):
            raise AssertionError(f"2ppu K1 launches: {run['counts']}")
        if run["meta"].get("target_state") != "2ppu" or \
                run["meta"].get("m_abs") != 1:
            raise AssertionError(f"2ppu meta: {run['meta']}")

        phase("18e make excited-2ssg's evaluate (cli evaluate "
              "artifacts/excited_2ssg.npz --dtype float64 --target-state "
              "2ssg --contam-vs artifacts/flagship_separable.npz)")
        ks.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res, err = run_cli(["evaluate", os.path.join(art, "excited_2ssg.npz"),
                            "--dtype", "float64", "--target-state", "2ssg",
                            "--contam-vs", flagship, "--out",
                            os.path.join(work, "evaluate"), "--device",
                            "cuda"])
        counts = dict(ks.launches)
        print(f"cli evaluate: {time.time() - t0:.1f} s; "
              + err.strip().splitlines()[-1] + f"; K1 launches {counts}; "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
              f"({card})")
        rel = {k: abs(res[k] - v) / abs(v) for k, v in JAX_EVAL_2SSG.items()}
        print("against the JAX CLI: " + ", ".join(
            f"{k} {res[k]} ({v:.2e} rel)" for k, v in rel.items()))
        checks = {
            "int_*, contam_* equal to the JAX CLI's to 1e-6":
                max(rel.values()) <= 1e-6,
            "contam_max_frac < 1e-4": res["contam_max_frac"] < 1e-4,
            "fit_rms_mHa <= 0.01": res["fit_rms_mHa"] <= 0.01,
            # the flagship reference on the contamination grid, once; the
            # excited model's quotients through the factor epilogue
            "one K1-fwd launch, K1-fwd-ex for the rest":
                counts["separable_fwd"] == 1 and
                set(_nonzero(counts)) == {"separable_fwd",
                                          "separable_fwd_ex"},
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"excited-2ssg evaluate: {failed}")
        sys.stdout.flush()
    finally:
        shutil.rmtree(work, ignore_errors=True)


# phase 19: the paths across families. The Monte-Carlo runs (19c) are at
# the CLI's defaults (32 rows of 32 768 importance samples, float32) for
# MC_STEPS steps at MC_LR: they refine polished artifacts, a refinement
# rate (the CLI's default, 8e-3, is the rate of a run from the init)
MC_N_R, MC_N_PTS, MC_STEPS, MC_LBFGS, MC_LR = 32, 32768, 200, 20, 1e-3
# independent batches of the quotient check before and after a run
MC_CHECK_BATCHES = 4
# make train's batch and steps for 19a (N_TRAIN, TRAIN_STEPS); the minimal
# trainer's whole schedule (minimal_config) in 19d
MINIMAL_EPOCHS = 1000
# E_int of artifacts/flagship_model.bin (analysis.energy.rayleigh_quotient
# on the uniform n = 80 grid, float64) from the JAX package on the CPU: as
# the reference-parity symmetric model (its cli energy's default) and as
# the minimal family (minimal_config: R up to 3). The two differ only at
# second order (their difference in psi is inversion-odd), so the routing
# shows in the launch counts; tests/test_torch_families.py recomputes them
JAX_EINT_BIN = {
    "symmetric": {0.2: -1.4185241250189538, 1.0: -1.0488805515541029,
                  2.0: -0.7862253169737864, 4.0: -0.626719079675464},
    "minimal": {0.2: -1.418524124998788, 1.0: -1.0488805515507673,
                2.0: -0.7862253169656295, 3.0: -0.675652065505495},
}
# E_int of two seeded models from the JAX package on the CPU in float64,
# (uniform n = 80, spheroidal 96 x 96) at R = 0.5, 1, 2, 4: k3_weights()
# as the minimal family (P = +1), and seeded_weights(K3_SEED + 1, 3), an
# R-input symmetric model in the ungerade sector (no output bias, so its
# correction vanishes far from the nuclei)
JAX_EINT_FAMILY = {
    "minimal": {0.5: (-1.2646260658287007, -1.280558408684479),
                1.0: (-1.0360022350438975, -1.042318438947132),
                2.0: (-0.7759327820260057, -0.7785707802885264),
                4.0: (-0.6222670265357547, -0.6255104675434583)},
    "r_input": {0.5: (-0.5301221056597198, -0.4540909555218216),
                1.0: (-0.6741303089058084, -0.66063090434485),
                2.0: (-0.695974911152682, -0.6948777958985576),
                4.0: (-0.6229299019667652, -0.6232160727155952)},
}


def family_models():
    """The seeded models of phase 19d and the JAX golden tests: (weights,
    ModelConfig fields) by name."""
    return {"minimal": (k3_weights(), dict(arch="minimal")),
            "r_input": (seeded_weights(K3_SEED + 1, 3),
                        dict(inversion_symmetry=-1))}


def _nonzero(counts: dict) -> dict:
    """The launch counts that are not 0 (so that a check names exactly the
    builds a run launches, whatever other builds a module counts)."""
    return {k: v for k, v in counts.items() if v}


def _all_launches(*mods) -> dict:
    return {k: v for m in mods for k, v in m.launches.items()}


def _reset(*mods) -> None:
    for m in mods:
        m.reset_launches()


def _tree_grads(loss_fn, params: dict):
    """(loss, {(key, field): gradient}) of ``loss_fn(params)``: zeros for a
    leaf the loss does not reach."""
    import torch
    leaves = {(k, f): t.detach().clone().requires_grad_(True)
              for k, v in params.items() for f, t in v.items()}
    tree: dict = {}
    for (k, f), t in leaves.items():
        tree.setdefault(k, {})[f] = t
    loss = loss_fn(tree)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {kf: torch.zeros_like(t) if g is None else g
                           for (kf, t), g in zip(leaves.items(), gs)}


def _against_plain(label, loss_fn, params_dev, params_cpu, tol_v, tol_g):
    """A loss and its gradients on the card (the kernels) against the same
    on the host's CPU (their plain versions): the value to ``tol_v``
    relative, each gradient normwise to ``tol_g``. Returns (worst value
    error, worst gradient error) and the card's (loss, grads)."""
    l_k, g_k = _tree_grads(lambda p: loss_fn(p, "cuda"), params_dev)
    l_p, g_p = _tree_grads(lambda p: loss_fn(p, "cpu"), params_cpu)
    rel = abs(float(l_k) - float(l_p)) / abs(float(l_p))
    if not rel <= tol_v:
        raise AssertionError(f"{label}: loss {float(l_k)} against the plain "
                             f"{float(l_p)} (rel {rel:.3e} > {tol_v})")
    worst = max(check_normwise(f"{label} d{k}/{f}", g_k[(k, f)].cpu(),
                               g_p[(k, f)], tol_g)[1]
                for k, f in g_p if float(g_p[(k, f)].abs().max()) > 0)
    print(f"{label}: loss {float(l_k):.12e}, rel to the plain {rel:.3e} "
          f"(bound {tol_v}); gradients worst normwise {worst:.3e} (bound "
          f"{tol_g})")
    return (l_k, g_k)


# a float32 loss on the card against a float64 reference may be off by this
# many times the float32 plain path's own error, leaf by leaf, and by the
# floors at least: near an optimum a quotient's gradient is a difference of
# nearly equal sums, and float32's own error there is 3e-6 to 7e-3 of a
# leaf's scale (the plain path against float64 on the CPU, 131 072 points of
# the MC batch), which no fixed float32 bound holds
F32_PLAIN_FACTOR, F32_FLOOR_VALUE, F32_FLOOR_GRAD = 10.0, 1e-6, 1e-4


def against_plain_f32(label, loss_fn, params32):
    """A float32 loss and its gradients through the kernels (``loss_fn(p,
    "cuda")``), and through the plain path on the host's CPU in float32
    (``"cpu"``), each against the plain path in float64 on the same inputs
    cast up (``"cpu64"``): the card's errors, the value's relative and each
    gradient's normwise, no more than F32_PLAIN_FACTOR times the float32
    plain path's, or the floors."""
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    cpu = torch.device("cpu")
    l_k, g_k = _tree_grads(lambda p: loss_fn(p, "cuda"), params32)
    l_p, g_p = _tree_grads(lambda p: loss_fn(p, "cpu"),
                           ansatz.as_params(params32, torch.float32, cpu))
    l_r, g_r = _tree_grads(lambda p: loss_fn(p, "cpu64"),
                           ansatz.as_params(params32, torch.float64, cpu))
    ev = [abs(float(l) - float(l_r)) / abs(float(l_r)) for l in (l_k, l_p)]
    if not ev[0] <= max(F32_PLAIN_FACTOR * ev[1], F32_FLOOR_VALUE):
        raise AssertionError(f"{label}: loss {float(l_k)} against float64 "
                             f"{float(l_r)}: rel {ev[0]:.3e}, the float32 "
                             f"plain path's {ev[1]:.3e}")
    worst, worst_key = 0.0, None
    for key, ref in g_r.items():
        scale = float(ref.abs().max())
        if scale == 0.0:
            continue
        ek, ep = (float((g[key].cpu().double() - ref).abs().max()) / scale
                  for g in (g_k, g_p))
        bound = max(F32_PLAIN_FACTOR * ep, F32_FLOOR_GRAD)
        if not ek <= bound:
            raise AssertionError(f"{label} d{key[0]}/{key[1]}: normwise "
                                 f"{ek:.3e} against float64, the float32 "
                                 f"plain path's {ep:.3e} (bound {bound:.3e})")
        if ek / bound >= worst:
            worst, worst_key = ek / bound, (key, ek, ep)
    (k, f), ek, ep = worst_key
    print(f"{label}: loss {float(l_k):.9e}, rel to float64 {ev[0]:.3e} (the "
          f"float32 plain path's {ev[1]:.3e}); gradients nearest their "
          f"bound at d{k}/{f}: normwise {ek:.3e} (the float32 plain path's "
          f"{ep:.3e}; {worst:.3f} of the bound)")


def mc_kernel_check(mod, params, mcfg, vb, card: str,
                    where: str = "MC") -> dict:
    """A float32 kernel pair (K1 of ``ops.pallas_separable`` or K2 of
    ``ops.pallas_train``) at a Monte-Carlo batch (``vb``: r per row of x),
    or at a residual batch (r per point): the forward elementwise and the
    backward normwise (on random cotangents) against the plain versions at
    the kernel's float32 bounds, two backward launches bit for bit, and the
    times of both (K1's point-gradient launch too) beside the plain
    versions and the bound. Returns the times, bounds and errors."""
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    k1 = hasattr(mod, "separable_fwd_cuda")
    dt = torch.float32
    rr = vb.r if vb.r.shape == vb.x.shape else \
        vb.r[:, None].expand_as(vb.x).reshape(-1)
    pts = tuple(t.reshape(-1) for t in (vb.x, vb.y, vb.z))
    n = rr.numel()
    p_sym = mcfg.inversion_symmetry
    with torch.no_grad():
        a = ansatz.orbital_exponent(params, rr)
        b = ansatz.gz_exponent(params, rr, p_sym, a)
    if k1:
        name, kernel, names = "K1", "K1", K1_GRADS
        ws = mod.kernel_weights(params, dt)
        args = (a, b, *pts, rr)
        kw = dict(p_sym=p_sym, ry=mcfg.ry, rz=mcfg.rz)
        fwd, fwd_plain = mod.separable_fwd_cuda, mod.psi_lap_separable_plain
        bwd, bwd_plain = (mod.separable_bwd_cuda,
                          mod.psi_lap_separable_vjp_plain)
        bounds = k1_f32_bounds
    else:
        name, kernel, names = "K2", "K2", K2_GRADS
        with torch.no_grad():
            g = ansatz.gate(params, rr)
        ws = mod.kernel_weights(params, mcfg, dt)
        args = (a, b, g, *pts, rr)
        kw = dict(p_sym=p_sym)
        fwd, fwd_plain = mod.train_fwd_cuda, mod.psi_lap_train_plain
        bwd, bwd_plain = mod.train_bwd_cuda, mod.psi_lap_train_vjp_plain
        bounds = k2_f32_bounds
    gen = torch.Generator(device=rr.device).manual_seed(0)
    dpsi = torch.randn(n, generator=gen, device=rr.device, dtype=dt)
    dlap = torch.randn(n, generator=gen, device=rr.device, dtype=dt)
    with torch.no_grad():
        psi_k, lap_k = fwd(ws, *args, **kw)
        psi_p, lap_p = fwd_plain(ws, *args, **kw)
        got, again = (bwd(ws, *args, dpsi, dlap, **kw) for _ in range(2))
        want = bwd_plain(ws, *args, dpsi, dlap, **kw)
    torch.cuda.synchronize()
    tol_psi, tol_lap, tol_bwd = bounds(psi_p, lap_p)
    label = f"{name} float32 at the {where} batch ({n} points)"
    e_psi = check_close(f"{name}-fwd psi {where}", psi_k, psi_p, *tol_psi)
    e_lap = check_close(f"{name}-fwd lap {where}", lap_k, lap_p, *tol_lap)
    got, again, want = ([*out[0], *out[1:]] for out in (got, again, want))
    worst = max((check_normwise(f"{name}-bwd {nm} {where}", u, v, tol_bwd)
                 for nm, u, v in zip(names, got, want)), key=lambda e: e[1])
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise AssertionError(f"{label}: two backward launches differ")
    print(f"{label}: fwd psi max abs {e_psi[0]:.3e} rel {e_psi[1]:.3e} | lap "
          f"max abs {e_lap[0]:.3e} rel {e_lap[1]:.3e} | bwd worst normwise "
          f"{worst[1]:.3e} (bound {tol_bwd}); two backward launches bitwise "
          f"equal")
    with torch.no_grad():
        t = {"fwd": cuda_ms(lambda: fwd(ws, *args, **kw),
                            label=f"{name}-fwd f32 {where}"),
             "fwd_plain": cuda_ms(lambda: fwd_plain(ws, *args, **kw), reps=2,
                                  label=f"{name}-fwd plain"),
             "bwd": cuda_ms(lambda: bwd(ws, *args, dpsi, dlap, **kw),
                            label=f"{name}-bwd f32 {where}"),
             "bwd_plain": cuda_ms(lambda: bwd_plain(ws, *args, dpsi, dlap,
                                                    **kw), reps=2,
                                  label=f"{name}-bwd plain")}
        if k1:
            t["bwd_pg"] = cuda_ms(lambda: bwd(ws, *args, dpsi, dlap,
                                              point_grads=True, **kw),
                                  label=f"K1-bwd PG f32 {where}")
            t["bwd_pg_plain"] = cuda_ms(lambda: bwd_plain(
                ws, *args, dpsi, dlap, point_grads=True, **kw), reps=1,
                label="K1-bwd PG plain")
    for which in ("fwd", "bwd") + (("bwd_pg",) if k1 else ()):
        t[which + "_bound"], t[which + "_bound_by"] = bound_ms(
            n, ws[0].shape[1], "float32", which, kernel=kernel)
    print(f"float32 {name} at the {where} batch ({n} points, H = "
          f"{ws[0].shape[1]}): {name}-fwd {t['fwd']:.4f} ms (plain "
          f"{t['fwd_plain']:.4f}, bound {t['fwd_bound']:.4f} "
          f"{t['fwd_bound_by']}) | {name}-bwd {t['bwd']:.4f} ms (plain "
          f"{t['bwd_plain']:.4f}, bound {t['bwd_bound']:.4f} "
          f"{t['bwd_bound_by']})" + (
              f" | K1-bwd PG {t['bwd_pg']:.4f} ms (plain "
              f"{t['bwd_pg_plain']:.4f}, bound {t['bwd_pg_bound']:.4f} "
              f"{t['bwd_pg_bound_by']})" if k1 else "") + f" ({card})",
          flush=True)
    t["fwd_err"] = max(e_psi[0], e_lap[0])
    t["bwd_err"] = worst[0]
    return t


def family_phase(dev, card: str) -> dict:
    """Phase 19: the paths across families (separable params on the
    residual trainer, symmetric params on the spheroidal polish, the
    Monte-Carlo trainer, the minimal family and R-input models). Returns
    19c's times of each family's float32 kernels at the MC batch."""
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
        pallas_residual as k3
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_train as kt
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops.sampling \
        import Batch, sample_batch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        losses, variational

    art = os.path.join(HERE, "artifacts")
    flagship_sym = os.path.join(art, "flagship.npz")
    flagship_sep = os.path.join(art, "flagship_separable.npz")
    mods = (ks, kt, k3)
    cpu = torch.device("cpu")
    mc_times = {}   # 19c: each family's kernels at the MC batch
    work = tempfile.mkdtemp(prefix="chip_smoke_families_")
    try:
        phase(f"19a separable on the residual trainer (cli train --arch "
              f"separable: make train's {N_TRAIN} points, float32, step "
              f"schedule; {TRAIN_STEPS} steps)")
        flags = ["train", "--arch", "separable", "--lr-schedule", "step",
                 "--device", "cuda"]
        # warm-up outside the counted and timed run
        run_cli(flags + ["--epochs", str(WARMUP_STEPS), "--out",
                         os.path.join(work, "warm")])
        out = os.path.join(work, "sep")
        _reset(*mods)
        torch.cuda.reset_peak_memory_stats()
        run_cli(flags + ["--epochs", str(TRAIN_STEPS), "--out", out])
        counts = _all_launches(*mods)
        _, meta = checkpoint.load_params(os.path.join(out, "final.npz"))
        rate = TRAIN_STEPS / meta["runtime_s"]
        print(f"cli train --arch separable: {rate:.2f} steps/s, "
              f"{rate * N_TRAIN:.4e} points/s; launches {counts} "
              f"({counts['separable_fwd'] / TRAIN_STEPS:.2f} K1-fwd and "
              f"{counts['separable_bwd'] / TRAIN_STEPS:.2f} K1-bwd a step); "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
              f"({card})")
        want = dict.fromkeys(counts, 0)
        want.update(separable_fwd=TRAIN_STEPS, separable_bwd=TRAIN_STEPS)
        if counts != want:
            raise AssertionError(f"19a launches: {counts}")
        scfg = config.Config(model=config.ModelConfig(arch="separable"))
        scfg = scfg.replace(train=dataclasses.replace(
            scfg.train, lr_schedule="step"))
        fixed = sample_batch(torch.Generator(device=dev).manual_seed(1),
                             scfg, device=dev)
        fixed_cpu = Batch(*(t.cpu() for t in fixed))
        best = _load_npz_params(os.path.join(out, "best.npz"))

        def train_loss(p, where):
            b = fixed if where == "cuda" else fixed_cpu
            return losses.loss_fn(p, scfg, b)[0]

        init = ansatz.init_params(scfg.model, seed=scfg.train.seed,
                                  dtype="float32", device=dev)
        with torch.no_grad():
            loss0 = float(train_loss(init, "cuda"))
        loss1, _ = _against_plain(
            f"loss_fn (K1, float32, {N_TRAIN} points)", train_loss,
            ansatz.from_jax_params(best, dtype="float32", device=dev),
            ansatz.from_jax_params(best, dtype="float32", device=cpu),
            1e-4, 1e-4)
        print(f"loss on a fixed batch: {loss0:.6e} (init) -> "
              f"{float(loss1):.6e} (best)")
        if not (np.isfinite(float(loss1)) and float(loss1) < loss0):
            raise AssertionError(f"19a loss: {loss0} -> {float(loss1)}")
        sys.stdout.flush()

        phase(f"19b symmetric on the spheroidal polish (cli variational "
              f"--arch symmetric --spheroidal, n_r {N_R}, {N_XI} x {N_ETA} "
              f"dual grid, float64; {ADAM_STEPS} + {LBFGS_STEPS} steps)")
        grid = ["--n-r", str(N_R), "--n-xi", str(N_XI), "--n-eta",
                str(N_ETA), "--dtype", "float64", "--spheroidal",
                "--adam-warmup", str(ADAM_STEPS), "--lbfgs",
                str(LBFGS_STEPS)]
        sym_cfg = {
            "flagship": config.Config(
                model=config.ModelConfig(gz=True, trainable_exponent=True),
                dtype="float64"),
            "gerade": config.Config(dtype="float64"),
            "ungerade": config.Config(
                model=config.ModelConfig(inversion_symmetry=-1),
                dtype="float64")}
        runs = {"flagship": [flagship_sym, "--arch", "symmetric", "--gz",
                             "--trainable-exponent"],
                "gerade": ["--arch", "symmetric"],
                "ungerade": ["--arch", "symmetric", "--state", "ungerade"]}
        variational.polish_spheroidal(None, sym_cfg["gerade"], n_r=2,
                                      n_xi=8, n_eta=6, steps=2,
                                      adam_steps=2, device=dev)
        outs = {}
        for name, flags in runs.items():
            cfg = sym_cfg[name]
            _reset(*mods)
            run = excited_polish(f"symmetric polish ({name})", flags + grid,
                                 "quotient_loss", card, work, kt)
            c = run["counts"]
            if c["train_fwd"] <= 0 or c["train_bwd"] <= 0 or \
                    c["train_bwd_pg"] or any(ks.launches.values()) or \
                    any(k3.launches.values()):
                raise AssertionError(f"19b {name} launches: {c}, K1 "
                                     f"{ks.launches}, K3 {k3.launches}")
            lb = (run["evals"] - ADAM_STEPS) / LBFGS_STEPS
            print(f"  K2 a step: Adam 1 + 1; L-BFGS "
                  f"{(c['train_fwd'] - ADAM_STEPS) / LBFGS_STEPS:.2f} fwd, "
                  f"{(c['train_bwd'] - ADAM_STEPS) / LBFGS_STEPS:.2f} bwd "
                  f"({lb:.2f} evaluations, the validation grid's forward "
                  "included in fwd)")
            vb = variational.dual_grid_vbatch(cfg, N_R, N_XI, N_ETA,
                                              device=dev)
            vbv = variational.validation_vbatch(cfg, N_R, N_XI, N_ETA,
                                                device=dev)
            start = (ansatz.from_jax_params(_load_npz_params(flagship_sym),
                                            dtype="float64", device=dev)
                     if name == "flagship" else
                     ansatz.init_params(cfg.model, seed=cfg.train.seed,
                                        dtype="float64", device=dev))
            outs[name] = ansatz.from_jax_params(run["params"], device=dev)
            with torch.no_grad():
                (t0_, t1_), (v0, v1) = (
                    [float(variational.quotient_loss(p, cfg, b)[0])
                     for p in (start, outs[name])] for b in (vb, vbv))
            print(f"  training-grid loss {t0_:.12f} -> {t1_:.12f}; "
                  f"validation {v0:.12f} -> {v1:.12f}")
            # the polished flagship is only held finite: its Adam warmup
            # may leave the optimum, and the best iterate is selected among
            # the L-BFGS iterates after it
            if not (np.isfinite(t1_) and np.isfinite(v1)):
                raise AssertionError(f"19b {name}: loss {t1_}, {v1}")
            if name != "flagship" and not (t1_ < t0_ and v1 < v0):
                raise AssertionError(f"19b {name}: loss {t0_} -> {t1_}, "
                                     f"validation {v0} -> {v1}")
        for name in ("flagship", "ungerade"):
            cfg = sym_cfg[name]
            vb = variational.dual_grid_vbatch(cfg, N_R, N_XI, N_ETA,
                                              device=dev)
            vb_cpu = variational.VBatch(*(t.cpu() for t in vb))
            params = outs[name]

            def quotient(p, where, _cfg=cfg, _vb=vb, _vbc=vb_cpu):
                return variational.quotient_loss(
                    p, _cfg, _vb if where == "cuda" else _vbc)[0]

            l1, g1 = _against_plain(
                f"quotient_loss ({name}, K2 float64, padded batch of "
                f"{vb.x.numel()} points)", quotient, params,
                ansatz.as_params(params, torch.float64, cpu), 1e-10, 1e-8)
            _reset(*mods)
            l2, g2 = _tree_grads(lambda p: quotient(p, "cuda"), params)
            pad = vb.w == 0
            moved = variational.VBatch(
                torch.where(pad, 2.5, vb.x), torch.where(pad, 0.7, vb.y),
                torch.where(pad, 0.3, vb.z), vb.w, vb.r)
            l3, g3 = _tree_grads(lambda p: variational.quotient_loss(
                p, cfg, moved)[0], params)
            torch.cuda.synchronize()
            repeat = torch.equal(l1, l2) and all(torch.equal(g1[k], g2[k])
                                                 for k in g1)
            pads = torch.equal(l1, l3) and all(torch.equal(g1[k], g3[k])
                                               for k in g1)
            print(f"  {int(pad.sum())} pad points: moving them leaves the "
                  f"loss and gradients bit for bit: {pads}; two backward "
                  f"launches bitwise equal: {repeat}; K2 launches "
                  f"{dict(kt.launches)}")
            if not (repeat and pads):
                raise AssertionError(f"19b {name}: repeat {repeat}, pads "
                                     f"{pads}")
            if kt.launches["train_bwd"] != 2 or kt.launches["train_fwd"] != 2:
                raise AssertionError(f"19b {name}: K2 launches {kt.launches}")
            if name == "ungerade" and bool(g1[("out", "b")].any()):
                raise AssertionError("19b: the ungerade output bias got a "
                                     "gradient")
            if name == "flagship":
                prof = {k: {f: t.detach().clone().requires_grad_(True)
                            for f, t in v.items()} for k, v in params.items()}

                def sym_eval(_cfg=cfg, _vb=vb, _p=prof):
                    variational.quotient_loss(_p, _cfg, _vb)[0].backward()

                for _ in range(3):
                    sym_eval()
                wall_ms, busy_ms, by_kernel = profile_device(
                    sym_eval, 10, f"symmetric polish evaluation (K2 "
                    f"float64, {vb.x.numel()} points)")
                k_ms = sum(v for key, v in by_kernel.items()
                           if "train_" in key and "GateSource" not in key)
                print(f"  K2's share of the busy time {k_ms / busy_ms:.4f} "
                      f"({k_ms:.4f} of {busy_ms:.4f} ms) ({card})")
        sys.stdout.flush()

        phase(f"19c Monte-Carlo variational trainer (cli variational: "
              f"--n-r {MC_N_R} --n-pts {MC_N_PTS} --antithetic "
              f"--stratified-r, float32, {MC_STEPS} steps at lr {MC_LR}; "
              f"then --lbfgs {MC_LBFGS} in float64)")
        mc = ["variational", "--n-r", str(MC_N_R), "--n-pts", str(MC_N_PTS),
              "--antithetic", "--stratified-r", "--lr", str(MC_LR),
              "--device", "cuda"]
        n_step = MC_N_R * MC_N_PTS
        for name, src, flags, mod in (
                ("symmetric", flagship_sym, [], kt),
                ("separable", flagship_sep, ["--arch", "separable"], ks)):
            cfg = config.Config(model=config.ModelConfig(
                arch=name if name == "separable" else "symmetric"))
            run_cli(mc + [src, "--epochs", "5", "--out",
                          os.path.join(work, "mc_warm")] + flags)
            out = os.path.join(work, f"mc_{name}")
            _reset(*mods)
            torch.cuda.reset_peak_memory_stats()
            res, _ = run_cli(mc + [src, "--epochs", str(MC_STEPS), "--out",
                                   out] + flags)
            counts = _all_launches(*mods)
            peak = torch.cuda.max_memory_allocated()
            # the JSON's runtime_s is rounded to 10 ms, its points/s to 0.1
            rate = res["points_per_sec"] / n_step
            print(f"MC {name}: {rate:.2f} steps/s, "
                  f"{res['points_per_sec']:.4e} points/s ({n_step} a step); "
                  f"launches {counts}; peak device memory "
                  f"{peak / 2 ** 30:.3f} GiB ({card})")
            fwd, bwd = ("separable_fwd", "separable_bwd") \
                if mod is ks else ("train_fwd", "train_bwd")
            want = dict.fromkeys(counts, 0)
            want.update({fwd: MC_STEPS, bwd: MC_STEPS})
            if counts != want:
                raise AssertionError(f"19c {name} launches: {counts}")
            start = ansatz.from_jax_params(_load_npz_params(src),
                                           dtype="float32", device=dev)
            ema = ansatz.from_jax_params(
                _load_npz_params(os.path.join(out, "variational.npz")),
                dtype="float32", device=dev)
            e = []
            for k in range(MC_CHECK_BATCHES):
                vb = variational.sample_vbatch(
                    torch.Generator(device=dev).manual_seed(1000 + k), cfg,
                    MC_N_R, MC_N_PTS, antithetic=True, stratified=True)
                with torch.no_grad():
                    e.append([float(variational.quotient_loss(p, cfg, vb)[1]
                                    ["e_mean"]) for p in (start, ema)])
            e = np.array(e)
            se = e[:, 0].std(ddof=1) / np.sqrt(len(e))
            rise = e[:, 1].mean() - e[:, 0].mean()
            print(f"  mean quotient over {len(e)} fresh batches: "
                  f"{e[:, 0].mean():.9f} (start, standard error {se:.3e}) "
                  f"-> {e[:, 1].mean():.9f} (EMA): {rise:+.3e}")
            if not (np.isfinite(e).all() and rise <= 3.0 * se):
                raise AssertionError(f"19c {name}: the quotient rose by "
                                     f"{rise} (3 SE = {3 * se})")
            params = ansatz.from_jax_params(_load_npz_params(src),
                                            dtype="float32", device=dev)

            def five_steps(_cfg=cfg, _p=params):
                variational.train_variational(
                    _cfg, params=_p, n_r=MC_N_R, n_pts=MC_N_PTS, epochs=5,
                    lr=MC_LR, antithetic=True, stratified=True, device=dev)

            wall_ms, busy_ms, by_kernel = profile_device(
                five_steps, 1, f"run of 5 MC steps ({name}, setup "
                "included)")
            k_ms = sum(v for key, v in by_kernel.items()
                       if ("separable_" in key if mod is ks
                           else "train_" in key and "GateSource" not in key))
            # the profiler slows the host: the busy time a step against
            # the unprofiled run's step
            busy_step = busy_ms / 5
            print(f"  device busy {busy_step:.4f} ms a step of the "
                  f"unprofiled run's {1e3 / rate:.4f} ms: busy share "
                  f"{busy_step * rate / 1e3:.4f} ({busy_ms / wall_ms:.4f} "
                  f"with the profiler on); {'K1' if mod is ks else 'K2'}'s "
                  f"share of the busy time {k_ms / busy_ms:.4f} "
                  f"({k_ms / 5:.4f} ms a step) ({card})", flush=True)
        # the models no kernel carries, at the same batch: the plain
        # forward-Laplacian path keeps its (points, 3, H) triples for
        # autograd; its peak memory and rate
        for name, fields in (("minimal", dict(arch="minimal")),
                             ("r_input", dict(r_input=True))):
            cfg = config.Config(model=config.ModelConfig(**fields))
            fw = {"minimal": config.minimal_config(),
                  "r_input": cfg}[name]
            fw = fw.replace(model=cfg.model)
            variational.train_variational(fw, n_r=MC_N_R, n_pts=MC_N_PTS,
                                          epochs=2, lr=MC_LR, device=dev)
            _reset(*mods)
            torch.cuda.reset_peak_memory_stats()
            res = variational.train_variational(
                fw, n_r=MC_N_R, n_pts=MC_N_PTS, epochs=10, lr=MC_LR,
                antithetic=True, stratified=True, device=dev)
            peak = torch.cuda.max_memory_allocated()
            counts = _all_launches(*mods)
            print(f"MC {name} (the plain fwdlap path): "
                  f"{10 / res.runtime_s:.2f} steps/s; peak device memory "
                  f"{peak / 2 ** 30:.3f} GiB; launches {counts} ({card})")
            if any(counts.values()) or not np.isfinite(
                    res.history["Ltot"]).all():
                raise AssertionError(f"19c MC {name}: {counts}, "
                                     f"{res.history['Ltot']}")
        # the kernels at the Monte-Carlo batch in float32, K1 on the
        # separable flagship and K2 on the symmetric one: each launch
        # against its plain version and timed beside it and the bound, and
        # the quotient and its gradients on that batch against the plain
        # path's
        for name, src, mcfg, mod in (
                ("separable", flagship_sep,
                 config.ModelConfig(arch="separable"), ks),
                ("symmetric", flagship_sym,
                 config.ModelConfig(gz=True, trainable_exponent=True), kt)):
            cfg = config.Config(model=mcfg)
            p32 = ansatz.from_jax_params(_load_npz_params(src),
                                         dtype="float32", device=dev)
            vb = variational.sample_vbatch(
                torch.Generator(device=dev).manual_seed(7), cfg, MC_N_R,
                MC_N_PTS, antithetic=True, stratified=True)
            mc_times[name] = mc_kernel_check(mod, p32, mcfg, vb, card)
            vb_cpu = variational.VBatch(*(t.cpu() for t in vb))
            vb_64 = variational.VBatch(*(t.double() for t in vb_cpu))
            cfg64 = cfg.replace(dtype="float64")

            def quotient(p, where, _cfg=cfg, _cfg64=cfg64, _vb=vb,
                         _vbc=vb_cpu, _vb64=vb_64):
                c, b = {"cuda": (_cfg, _vb), "cpu": (_cfg, _vbc),
                        "cpu64": (_cfg64, _vb64)}[where]
                return variational.quotient_loss(p, c, b)[0]

            against_plain_f32(
                f"quotient_loss ({name}, {'K1' if mod is ks else 'K2'} "
                f"float32, MC batch of {n_step} points)", quotient, p32)

        lb_out = os.path.join(work, "mc_lbfgs")
        cfg = config.Config(model=config.ModelConfig(arch="separable"),
                            dtype="float64")
        real, evals = variational.quotient_loss, [0]

        def counted(*a, **k):
            if torch.is_grad_enabled():
                evals[0] += 1
            return real(*a, **k)

        variational.quotient_loss = counted
        try:
            _reset(*mods)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.time()
            res, _ = run_cli(["variational", flagship_sep, "--arch",
                              "separable", "--lbfgs", str(MC_LBFGS),
                              "--n-r", str(MC_N_R), "--n-pts",
                              str(MC_N_PTS), "--dtype", "float64",
                              "--device", "cuda", "--out", lb_out])
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            variational.quotient_loss = real
        counts = _all_launches(*mods)
        print(f"cli variational --lbfgs {MC_LBFGS} (separable, float64, "
              f"{n_step} points): {wall:.2f} s, {MC_LBFGS / wall:.2f} steps/s;"
              f" {evals[0] / MC_LBFGS:.2f} evaluations a step; launches "
              f"{counts}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
              f"({card})")
        if counts["separable_bwd"] != evals[0] or counts["separable_fwd"] \
                < evals[0] or any(kt.launches.values()):
            raise AssertionError(f"19c --lbfgs launches: {counts}")
        gen = torch.Generator(device=dev).manual_seed(cfg.train.seed + 7)
        r = torch.linspace(cfg.domain.r_lo, cfg.domain.r_hi, MC_N_R,
                           dtype=torch.float64, device=dev)
        from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops.sampling \
            import sample_importance
        vb = variational.VBatch(*sample_importance(gen, cfg, r, MC_N_PTS,
                                                   device=dev), r)
        with torch.no_grad():
            l0, l1 = (float(variational.quotient_loss(
                ansatz.from_jax_params(_load_npz_params(p), dtype="float64",
                                       device=dev), cfg, vb)[0])
                for p in (flagship_sep, os.path.join(lb_out,
                                                     "variational.npz")))
        print(f"  objective on its batch {l0:.12f} -> {l1:.12f}")
        if not (np.isfinite(l1) and l1 <= l0):
            raise AssertionError(f"19c --lbfgs: {l0} -> {l1}")
        # its first evaluation (the start on its batch) against the plain
        # path, at phase 19b's float64 bounds
        vb_cpu = variational.VBatch(*(t.cpu() for t in vb))
        start = ansatz.from_jax_params(_load_npz_params(flagship_sep),
                                       dtype="float64", device=dev)
        _against_plain(
            f"quotient_loss (separable, K1 float64, the --lbfgs batch of "
            f"{n_step} points)",
            lambda p, where: variational.quotient_loss(
                p, cfg, vb if where == "cuda" else vb_cpu)[0],
            start, ansatz.as_params(start, torch.float64, cpu), 1e-10, 1e-8)
        sys.stdout.flush()

        phase(f"19d the minimal family (cli train --arch minimal at "
              f"minimal_config: 10 000 points, {MINIMAL_EPOCHS} epochs, "
              "float32, not cut); model.bin and seeded models scored")
        mcfg = config.minimal_config()
        run_cli(["train", "--arch", "minimal", "--epochs",
                 str(WARMUP_STEPS), "--device", "cuda", "--out",
                 os.path.join(work, "min_warm")])
        out = os.path.join(work, "minimal")
        _reset(*mods)
        torch.cuda.reset_peak_memory_stats()
        run_cli(["train", "--arch", "minimal", "--device", "cuda", "--out",
                 out])
        counts = _all_launches(*mods)
        _, meta = checkpoint.load_params(os.path.join(out, "final.npz"))
        print(f"cli train --arch minimal: "
              f"{MINIMAL_EPOCHS / meta['runtime_s']:.2f} steps/s, "
              f"{MINIMAL_EPOCHS * mcfg.train.n_train / meta['runtime_s']:.4e}"
              f" points/s; launches {counts}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
              f"({card})")
        if any(counts.values()):
            raise AssertionError(f"19d: the minimal family launched a "
                                 f"kernel: {counts}")
        fixed = sample_batch(torch.Generator(device=dev).manual_seed(1),
                             mcfg, device=dev)
        init = ansatz.init_params(mcfg.model, seed=mcfg.train.seed,
                                  dtype="float32", device=dev)
        best_path = os.path.join(out, "best.npz")
        with torch.no_grad():
            l0, l1 = (float(losses.loss_fn(p, mcfg, fixed)[0]) for p in (
                init, ansatz.from_jax_params(_load_npz_params(best_path),
                                             dtype="float32", device=dev)))
        print(f"loss on a fixed batch: {l0:.6e} (init) -> {l1:.6e} (best)")
        if not (np.isfinite(l1) and l1 < l0):
            raise AssertionError(f"19d loss: {l0} -> {l1}")
        pkl = os.path.join(work, "minimal_energy.pkl")
        t0 = time.time()
        summary, _ = run_cli(["energy", best_path, "--arch", "minimal",
                              "--device", "cuda", "--out", pkl])
        surf = energy.load_surface(pkl)
        print(f"cli energy --arch minimal (float32): {len(surf['R'])} R in "
              f"{time.time() - t0:.2f} s; launches {_all_launches(*mods)}")
        if not all(np.all(np.isfinite(v)) for v in surf.values()) or \
                any(_all_launches(*mods).values()):
            raise AssertionError("19d: the trained minimal model's surface")

        model_bin = os.path.join(art, "flagship_model.bin")
        for arch, want in JAX_EINT_BIN.items():
            pkl = os.path.join(work, f"bin_{arch}.pkl")
            _reset(*mods)
            t0 = time.time()
            run_cli(["energy", model_bin, "--arch", arch, "--dtype",
                     "float64", "--device", "cuda", "--out", pkl])
            surf = energy.load_surface(pkl)
            counts = _all_launches(*mods)
            got = {float(ri): e for ri, e in zip(surf["R"], surf["E_int"])}
            rel = max(abs(got[ri] - w) / abs(w) for ri, w in want.items())
            print(f"cli energy flagship_model.bin --arch {arch} (float64): "
                  f"{len(surf['R'])} R in {time.time() - t0:.2f} s; E_int at "
                  f"{sorted(want)} against JAX: max rel {rel:.3e}; launches "
                  f"{counts}")
            want_k3 = len(surf["R"]) if arch == "symmetric" else 0
            if not rel <= 1e-10 or counts["residual_fwd"] != want_k3 or \
                    sum(counts.values()) != want_k3:
                raise AssertionError(f"19d .bin as {arch}: rel {rel}, "
                                     f"launches {counts}")
        _reset(*mods)
        for name, (weights, fields) in family_models().items():
            cfg = config.Config(model=config.ModelConfig(**fields),
                                dtype="float64")
            params = ansatz.from_jax_params(weights, dtype="float64",
                                            device=dev)
            worst = 0.0
            for ri, want in JAX_EINT_FAMILY[name].items():
                got = (energy.rayleigh_quotient(params, cfg, ri, n=80),
                       energy.rayleigh_quotient_spheroidal(params, cfg, ri))
                worst = max(worst, *(abs(g - w) / abs(w)
                                     for g, w in zip(got, want)))
            print(f"seeded {name} model: E_int (80^3, spheroidal) at "
                  f"{sorted(JAX_EINT_FAMILY[name])} against JAX: max rel "
                  f"{worst:.3e}")
            if not worst <= 1e-10:
                raise AssertionError(f"19d {name}: rel {worst}")
        if any(_all_launches(*mods).values()):
            raise AssertionError(f"19d: a seeded model launched a kernel: "
                                 f"{_all_launches(*mods)}")
        sys.stdout.flush()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return mc_times


# phase 20: the analysis suite. 20a runs cli analyze --paper-set's data at
# its defaults (spheroidal surface on 39 R, 60 force R, 9 Hellmann-Feynman
# R, the 80^3 cubes of the probes) for these checkpoints, each in the dtype
# cli analyze scores it in (--dtype float64, or the default float32), with
# the forward kernel its model quotients launch (K1's factor
# instantiation for the excited families)
ANALYZE_CKPTS = (("flagship_separable.npz", "float64", "separable_fwd"),
                 ("flagship.npz", "float64", "train_fwd"),
                 ("flagship_model.bin", "float32", "residual_fwd"),
                 ("excited_2ssg.npz", "float64", "separable_fwd_ex"))
ANALYZE_N_R = 39
# the card's arrays against the host CPU's, max |diff| / max |host| per
# array: float64 1e-10; float32 (flagship_model.bin at the default --dtype)
# by array, the quotients and normalisation constants being sums over 9 216
# and 512 000 points in other orders, and psi's values elementwise ulps.
# The float32 finite differences cancel about four digits of E over 2e-4:
# their bound is absolute (Ha/bohr)
ANALYZE_F32 = {"E_int": 2e-5, "Elcao": 2e-5, "E_net": 1e-6,
               "forces autograd": 1e-5, "forces hf": 1e-4, "norms": 1e-5,
               "cut": 1e-5, "plane": 1e-5, "importance curve": 5e-5,
               "curve": 1e-6}
# (the importance curve is the gate f(R) of flagship_model.bin, whose
# output (at most 6.3e-3) is a 170-fold cancellation of its terms: float32's
# own error there is 1.08e-5 of the largest, against float64 on the CPU)
# torch's CPU threads while the host references run: 8 threads on the
# card's 8 host cores make the reference's many small ops 4-5x slower than
# 4 do (oversubscription; the card's path itself is not affected)
HOST_THREADS = 4
ANALYZE_F32_FD_ABS = 5e-3
# cli train --profile (20d): steps and batch, and the K2 kernels the trace
# must name
PROFILE_STEPS, PROFILE_POINTS = 5, 4096


def analysis_arrays(d: dict) -> dict:
    """Every array of plots.paper_set_data's result that a paper-set
    figure draws, flat, by name."""
    import numpy as np
    s, f = d["surface"], d["forces"]
    out = {k: np.asarray(s[k]) for k in ("E_int", "Elcao", "E_net")}
    out.update({f"forces {k}": np.asarray(f[k])
                for k in ("autograd", "fd", "hf")})
    out["norms"] = np.array([v for ri in sorted(d["norms"])
                             for v in d["norms"][ri]])
    for ri, (_, p, pl) in sorted(d["raw_cuts"].items()):
        out[f"psi cut R={ri:g}"] = p
        out[f"lcao cut R={ri:g}"] = pl
    for ri, (_, p, pl) in sorted(d["grid"]["cuts"].items()):
        out[f"normalised cut R={ri:g}"] = np.concatenate([p, pl])
    for ri, (_, _, psi) in sorted(d["planes"].items()):
        out[f"psi plane R={ri:g}"] = psi
    out["E head curve"] = np.asarray(d["energy_curve"][1])
    out["importance curve"] = np.asarray(d["grid"]["importance"][1])
    out["E head 400 curve"] = np.asarray(d["grid"]["e_net_curve"])
    return out


def analysis_bound(name: str, dtype: str) -> tuple[float, bool]:
    """(bound, absolute?) of an analysis array's card-vs-host check."""
    if dtype == "float64":
        return 1e-10, False
    if name == "forces fd":
        return ANALYZE_F32_FD_ABS, True
    for key, bound in ANALYZE_F32.items():
        if key in name:
            return bound, False
    raise KeyError(name)


def analysis_phase(dev, card: str) -> None:
    """Phase 20: the analysis suite on the card (cli analyze --paper-set's
    data against the host CPU, its launches, drawing; cli vibrations, cli
    export, cli train --profile)."""
    import argparse

    import numpy as np
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import cli
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
        energy, etab, plots
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
        checkpoint, modelbin, torch_pt
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_residual as k3
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_train as kt

    art = os.path.join(HERE, "artifacts")
    mods = (ks, kt, k3)
    draw = plots.have_matplotlib()
    threads = torch.get_num_threads()
    work = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    try:
        phase("20a cli analyze --paper-set's data (39 R spheroidal surface, "
              "60 + 9 force R, 80^3 cubes) on the card against the host CPU")
        print("matplotlib: " + ("present, the figures are drawn" if draw else
                                "absent, the figures' data alone are "
                                "checked; nothing is drawn"))

        def host_data(params, cfg):
            t0 = time.time()
            return plots.paper_set_data(params, cfg), time.time() - t0

        runs = []
        for name, dtype, kernel in ANALYZE_CKPTS:
            ns = argparse.Namespace(
                checkpoint=os.path.join(art, name), state="gerade",
                dom_r_lo=None, dom_r_hi=None, dtype=dtype, device="cuda")
            cfg = cli._build_cfg(ns)
            cast = "float32" if dtype == "float32" else None
            params = cli._scoring_params(ns, cast)
            _reset(*mods)
            torch.cuda.synchronize()
            t0 = time.time()
            data = plots.paper_set_data(params, cfg)
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = _all_launches(*mods)
            want = {k: 0 for k in counts}
            if kernel:
                want[kernel] = ANALYZE_N_R
            if counts != want or len(data["surface"]["R"]) != ANALYZE_N_R:
                raise AssertionError(f"20a {name}: launches {counts}, "
                                     f"expected {want}")
            sec = data["seconds"]
            print(f"card: {name} ({dtype}, cfg arch {cfg.model.arch}) "
                  f"{wall:.3f} s: surface {sec['surface']:.3f} s, forces "
                  f"{sec['forces']:.3f} s, probes {sec['probes']:.3f} s; "
                  f"launches {counts} ({card})", flush=True)
            ns.device = "cpu"
            runs.append((name, dtype, params, cfg, data,
                         cli._scoring_params(ns, cast)))
        # where a paper set's time goes on the card: the device's busy share
        # (profiler on), and the host's construction of one quotient's
        # 96 x 96 spheroidal grid (numpy's Gauss-Legendre nodes), which
        # every quotient of the surface repeats
        _, params, cfg, _, _ = runs[0][1:6]
        profile_device(lambda: plots.paper_set_data(params, cfg), 1,
                       f"paper-set data ({runs[0][0]})")
        t0 = time.perf_counter()
        for _ in range(20):
            energy.spheroidal_grid(1.0, 96, 96)
        print(f"one 96 x 96 spheroidal grid on the host: "
              f"{(time.perf_counter() - t0) / 20 * 1e3:.3f} ms (of each of "
              f"the surface's {2 * ANALYZE_N_R} quotients)", flush=True)
        # the host CPU's references run on a thread beside the drawing
        # (torch's CPU kernels release the GIL)
        torch.set_num_threads(min(HOST_THREADS, threads))
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        jobs = [pool.submit(host_data, host_params, cfg)
                for _, _, _, cfg, _, host_params in runs]
        pool.shutdown(wait=False)
        for name, _, params, cfg, data, _ in runs if draw else ():
            plots.paper_set(params, cfg, os.path.join(work, name), data=data)
            print(f"drawing {name}'s paper set from the card's data: "
                  f"{data['seconds']['drawing']:.3f} s (the host "
                  "references' thread beside it)", flush=True)
        if draw:
            out = os.path.join(work, "cli_paper_set")
            t0 = time.time()
            res, _ = run_cli(["analyze", os.path.join(art, ANALYZE_CKPTS[0][0]),
                              "--paper-set", "--dtype", "float64", "--out",
                              out])
            names = sorted(os.path.basename(p) for p in res["figures"])
            want_names = sorted(set(plots.PAPER_SET_NAMES)
                                - {"loss_figure.pdf"})
            if names != want_names or sorted(os.listdir(out)) != want_names:
                raise AssertionError(f"20a cli analyze --paper-set wrote "
                                     f"{names}")
            print(f"cli analyze --paper-set: {len(names)} figures in "
                  f"{time.time() - t0:.2f} s (the host references' thread "
                  "beside it)", flush=True)
        for (name, dtype, _, cfg, data, _), job in zip(runs, jobs):
            host, host_wall = job.result()
            got, ref = analysis_arrays(data), analysis_arrays(host)
            worst = {}
            for key, w in ref.items():
                g = got[key]
                if g.shape != w.shape or g.dtype != w.dtype or \
                        not np.all(np.isfinite(g)):
                    raise AssertionError(f"20a {name} {key}: {g.shape} "
                                         f"{g.dtype} against {w.shape} "
                                         f"{w.dtype}")
                err = float(np.abs(g.astype(np.float64)
                                   - w.astype(np.float64)).max())
                bound, absolute = analysis_bound(key, dtype)
                val = err if absolute else err / float(np.abs(w).max())
                worst[key] = val
                if not val <= bound:
                    raise AssertionError(
                        f"20a {name} {key}: {val:.3e} > {bound} "
                        f"({'abs' if absolute else 'rel'})")
            top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
            print(f"host CPU: {name} {host_wall:.3f} s (n = "
                  f"{cfg.train.n_test} cubes); card against host, worst of "
                  f"{len(worst)} arrays: "
                  + ", ".join(f"{k} {v:.2e}" for k, v in top), flush=True)
        torch.set_num_threads(threads)

        phase("20b cli vibrations (the three rovib goldens, --j-max; the "
              "J = 0 ladder of evaluated.npz)")
        for golden in ("rovib_1ssg.json", "rovib_2ppu_well.json",
                       "rovib_3dsg_well.json"):
            with open(os.path.join(art, golden)) as fh:
                want = json.load(fh)
            t0 = time.time()
            got, _ = run_cli(["vibrations", os.path.join(HERE, want["source"]),
                              "--j-max", str(want["j_max"]), "--n-levels",
                              str(want["n_v"]), "--state", want["state"]])
            err = float(np.abs(np.asarray(got["levels_Ha"])
                               - np.asarray(want["levels_Ha"])).max())
            print(f"{golden}: levels against the golden max abs {err:.2e} "
                  f"Ha in {time.time() - t0:.2f} s")
            if not err <= 2e-9 or any(got[k] != want[k] for k in (
                    "state", "n_v", "j_max", "asymptote_Ha")):
                raise AssertionError(f"20b {golden}: {err}, {got}")
        got, _ = run_cli(["vibrations", os.path.join(art, "evaluated.npz")])
        if got["state"] != "1ssg" or len(got["levels_Ha"]) != 4:
            raise AssertionError(f"20b evaluated.npz: {got}")

        phase("20c cli export (.npz, .bin, .pt round trips; the e_table as "
              ".csv)")
        src = os.path.join(art, "flagship_separable.npz")
        dst = os.path.join(work, "sep.npz")
        run_cli(["export", src, dst])
        _same_arrays("20c .npz", checkpoint.load_params(dst)[0]["params"],
                     _load_npz_params(src))
        for ext in ("bin", "pt"):
            try:
                run_cli(["export", src, os.path.join(work, f"sep.{ext}")])
            except SystemExit as exc:
                print(f"  separable -> .{ext} refused: {exc}")
            else:
                raise AssertionError(f"20c: a separable .{ext} was written")
        src = os.path.join(art, "flagship_model.bin")
        want = modelbin.load_params(src)
        for ext, load in (("bin", modelbin.load_params),
                          ("pt", torch_pt.load_reference_checkpoint)):
            dst = os.path.join(work, f"model.{ext}")
            run_cli(["export", src, dst])
            _same_arrays(f"20c .{ext}", load(dst), want)
        with open(src, "rb") as a, open(os.path.join(work, "model.bin"),
                                        "rb") as b:
            same_bytes = a.read() == b.read()
        print(f"  model.bin re-exported byte for byte: {same_bytes}")
        csv = os.path.join(work, "table.csv")
        res, _ = run_cli(["export", os.path.join(art, "evaluated.npz"), csv])
        table = etab.load_table(os.path.join(art, "evaluated.npz"))
        with open(csv) as fh:
            rows = fh.read().splitlines()
        want_rows = ["R,E_electronic,E_total"] + [
            f"{r:.12g},{e:.15g},{e + 0.5 / r:.15g}"
            for r, e in zip(table["R"], table["E"])]
        if rows != want_rows or res["knots"] != 153:
            raise AssertionError(f"20c .csv: {len(rows) - 1} rows")
        print(f"  evaluated.npz -> .csv: {len(rows) - 1} rows equal to "
              "etab.load_table's knots")

        phase(f"20d cli train --profile ({PROFILE_STEPS} steps of "
              f"{PROFILE_POINTS} points, float32, K2)")
        run = os.path.join(work, "train")
        prof = os.path.join(work, "prof")
        _reset(*mods)
        t0 = time.time()
        run_cli(["train", "--epochs", str(PROFILE_STEPS), "--n-train",
                 str(PROFILE_POINTS), "--out", run, "--profile", prof])
        counts = _all_launches(*mods)
        trace = os.path.join(prof, "trace.json")
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        named = {k: sorted(n for n in kernels if k in n)[:1]
                 for k in ("train_fwd", "train_bwd")}
        print(f"trace {os.path.getsize(trace)} B, {len(events)} events, "
              f"{len(kernels)} kernel names, in {time.time() - t0:.2f} s; "
              f"launches {counts}; K2 in the trace: {named}")
        if counts["train_fwd"] != PROFILE_STEPS or \
                counts["train_bwd"] != PROFILE_STEPS or \
                not all(named.values()):
            raise AssertionError(f"20d: launches {counts}, trace {named}")
        if draw:
            out = os.path.join(work, "cli_paper_set_history")
            t0 = time.time()
            res, _ = run_cli(["analyze", os.path.join(art, ANALYZE_CKPTS[0][0]),
                              "--paper-set", "--dtype", "float64", "--out",
                              out, "--history",
                              os.path.join(run, "history.pkl")])
            names = sorted(os.listdir(out))
            if names != sorted(plots.PAPER_SET_NAMES):
                raise AssertionError(f"20d cli analyze --history: {names}")
            print(f"cli analyze --paper-set --history: {len(names)} figures "
                  f"(loss_figure.pdf among them) in {time.time() - t0:.2f} s")
        sys.stdout.flush()
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(work, ignore_errors=True)


# slice 11: the flagship recipe at full length (make flagship's flags), the
# per-R sweeps, and the runs that --mesh 1 must repeat bit for bit
FLAGSHIP_ADAM, FLAGSHIP_LBFGS = 1500, 800
FLAGSHIP_FLAGS = ["--arch", "separable", "--adam-warmup", str(FLAGSHIP_ADAM),
                  "--lbfgs", str(FLAGSHIP_LBFGS), "--spheroidal", "--n-r",
                  "39", "--n-xi", "40", "--n-eta", "24", "--dtype", "float64"]
MESH_TRAIN_STEPS = 20
SWEEP_R = ("0.5", "1", "2", "4")
SWEEP_POLISH_STEPS, SWEEP_EPOCHS = 300, 300
# the band of phase 4 and of the sweep's golden test (mHa above the oracle)
EINT_BAND = (-1e-4, 0.01)


def _eint_errors(pkl: str):
    """(R, E_int - exact in mHa) of a surface pickle, unrounded."""
    import pickle

    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
        energy
    with open(pkl, "rb") as f:
        surf = pickle.load(f)
    e = surf["E_int"] if "E_int" in surf else surf["E_net"]
    return surf["R"], 1e3 * (e - energy.exact_energy_ode(surf["R"]))


def _quotient_cases(dev) -> dict:
    """The sharded quotient's checkpoints in float64 on ``dev``: label ->
    (params, config): flagship.npz (K2-fwd) and flagship_model.bin (K3)."""
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import modelbin
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    art = os.path.join(HERE, "artifacts")
    return {
        "flagship.npz (K2-fwd)": (
            ansatz.from_jax_params(_load_npz_params(
                os.path.join(art, "flagship.npz")), dtype="float64",
                device=dev),
            config.Config(model=config.ModelConfig(
                gz=True, trainable_exponent=True), dtype="float64")),
        "flagship_model.bin (K3)": (
            ansatz.from_jax_params(modelbin.load_params(
                os.path.join(art, "flagship_model.bin")), dtype="float64",
                device=dev),
            config.Config(dtype="float64"))}


def mesh_sweep_phase(dev, card: str) -> None:
    """Phase 21 (slice 11): the flagship at full length through the sharded
    polish at world size 1 (NCCL), the --mesh 1 runs against the unsharded
    ones, and cli sweep in both modes."""
    import pickle

    import numpy as np
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
        energy
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_residual as k3
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_train as kt
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.parallel import \
        mesh as pmesh
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        sweep, variational

    art = os.path.join(HERE, "artifacts")
    mods = (ks, kt, k3)
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        phase(f"21a make flagship at full length through the sharded polish "
              f"(cli variational --mesh 1, NCCL at world size 1: "
              f"{FLAGSHIP_ADAM} Adam + {FLAGSHIP_LBFGS} L-BFGS steps), then "
              "cli evaluate --steps 8000 --dtype float64")
        _reset(*mods)
        run = excited_polish("flagship", FLAGSHIP_FLAGS + ["--mesh", "1"],
                             "quotient_loss", card, work)
        c = run["counts"]
        lbfgs_evals = (run["evals"] - FLAGSHIP_ADAM) / FLAGSHIP_LBFGS
        print(f"make flagship (--mesh 1): {run['wall']:.1f} s; Adam "
              f"{FLAGSHIP_ADAM / run['t_adam']:.2f} steps/s, L-BFGS "
              f"{FLAGSHIP_LBFGS / (run['wall'] - run['t_adam']):.2f} "
              f"steps/s, {lbfgs_evals:.3f} evaluations an L-BFGS step over "
              f"all {FLAGSHIP_LBFGS}; K1-fwd {c['separable_fwd']}, K1-bwd "
              f"{c['separable_bwd']} ({card})")
        if c["separable_fwd"] <= 0 or c["separable_bwd"] <= 0 or \
                c["separable_bwd_pg"]:
            raise AssertionError(f"21a launches: {c}")
        ev_dir = os.path.join(work, "flagship_eval")
        t0 = time.time()
        res, err = run_cli(["evaluate",
                            os.path.join(work, "flagship", "variational.npz"),
                            "--steps", "8000", "--dtype", "float64",
                            "--device", "cuda", "--out", ev_dir])
        print(f"cli evaluate: {time.time() - t0:.1f} s; "
              + err.strip().splitlines()[-1])
        r, e = _eint_errors(os.path.join(ev_dir, "energy_eval.pkl"))
        _, e_ship = _eint_errors(os.path.join(art, "energy_eval.pkl"))
        for label, v in (("fresh flagship", e), ("shipped artifact", e_ship)):
            print(f"E_int - exact over {len(r)} R ({label}): mean "
                  f"{np.abs(v).mean():.6f}, max {np.abs(v).max():.6f}, "
                  f"signed min {v.min():+.6f} mHa (max at R = "
                  f"{r[np.argmax(np.abs(v))]:.1f})")
        miss = [(float(ri), float(v)) for ri, v in zip(r, e)
                if not EINT_BAND[0] <= v <= EINT_BAND[1]]
        if miss:
            raise AssertionError(f"21a: the fresh flagship misses "
                                 f"{EINT_BAND} mHa at (R, mHa) {miss}")
        sys.stdout.flush()

        phase(f"21b --mesh 1 against the unsharded runs (the polish's "
              f"{ADAM_STEPS} Adam steps at the flagship grid; cli train at "
              f"make train's configuration, {MESH_TRAIN_STEPS} steps; "
              "rayleigh_quotient_sharded of flagship.npz (K2) and "
              "flagship_model.bin (K3))")
        cfg = config.Config(model=config.ModelConfig(arch="separable"),
                            dtype="float64")
        init = ansatz.init_params(cfg.model, seed=cfg.train.seed,
                                  dtype="float64", device=dev)

        def adam_losses(mesh):
            seen, real = [], variational.quotient_loss

            def record(*a, **k):
                out = real(*a, **k)
                if torch.is_grad_enabled():
                    seen.append(out[0].detach().clone())
                return out

            variational.quotient_loss = record
            try:
                # eager: a captured warmup calls its loss twice, at its
                # first step and at its capture
                p = variational.polish_spheroidal(
                    init, cfg, n_r=N_R, n_xi=N_XI, n_eta=N_ETA, steps=0,
                    adam_steps=ADAM_STEPS, mesh=mesh, device=dev,
                    graph=False)
            finally:
                variational.quotient_loss = real
            return (torch.stack(seen).cpu().numpy(),
                    ansatz.to_numpy_params(p))

        plain, p_plain = adam_losses(None)
        sharded, p_sharded = pmesh.launch(adam_losses, 1, device="cuda")
        if len(plain) != ADAM_STEPS or not np.array_equal(plain, sharded):
            raise AssertionError("21b: the polish's Adam losses differ under "
                                 "--mesh 1")
        _same_arrays(f"polish params after {ADAM_STEPS} Adam steps, "
                     "--mesh 1 and without", p_sharded, p_plain)
        print(f"  the {ADAM_STEPS} Adam losses equal bit for bit (last "
              f"{plain[-1]:.12f})")
        flags = ["train", "--gz", "--trainable-exponent", "--lr-schedule",
                 "step", "--epochs", str(MESH_TRAIN_STEPS), "--device",
                 "cuda"]
        hist = {}
        for mesh in ("0", "1"):
            out = os.path.join(work, f"train_mesh{mesh}")
            _reset(*mods)
            run_cli(flags + ["--mesh", mesh, "--out", out])
            counts = _all_launches(*mods)
            with open(os.path.join(out, "history.pkl"), "rb") as f:
                hist[mesh] = pickle.load(f)["Ltot"]
            print(f"  cli train --mesh {mesh}: launches {counts}")
            if counts["train_fwd"] != MESH_TRAIN_STEPS or \
                    counts["train_bwd"] != MESH_TRAIN_STEPS:
                raise AssertionError(f"21b train launches: {counts}")
        if not np.array_equal(hist["0"], hist["1"]):
            raise AssertionError("21b: cli train --mesh 1 differs from the "
                                 "unsharded run")
        _same_arrays("cli train final.npz, --mesh 1 and without",
                     _load_npz_params(os.path.join(work, "train_mesh1",
                                                   "final.npz")),
                     _load_npz_params(os.path.join(work, "train_mesh0",
                                                   "final.npz")))
        print(f"  the {MESH_TRAIN_STEPS} losses equal bit for bit (last "
              f"{hist['0'][-1]:.9e})")
        for label, (params, qcfg) in _quotient_cases(dev).items():
            want = energy.rayleigh_quotient(params, qcfg, 1.0, n=80)
            _reset(*mods)
            got = pmesh.launch(
                lambda m, p=params, q=qcfg: energy.rayleigh_quotient_sharded(
                    p, q, 1.0, m, n=80), 1, device="cuda")
            counts = {k: v for k, v in _all_launches(*mods).items() if v}
            rel = abs(got - want) / abs(want)
            print(f"  rayleigh_quotient_sharded, {label}, R = 1, n = 80: "
                  f"{got:.15f} against {want:.15f} (rel {rel:.2e}); "
                  f"launches {counts}")
            if not rel <= 1e-12 or not counts:
                raise AssertionError(f"21b sharded quotient {label}: rel "
                                     f"{rel}, launches {counts}")
        sys.stdout.flush()

        phase(f"21c cli sweep --polish {SWEEP_POLISH_STEPS} --arch separable "
              f"--dtype float64 at R = {', '.join(SWEEP_R)}")
        pkl = os.path.join(work, "sweep_polish.pkl")
        _reset(*mods)
        t0 = time.time()
        run_cli(["sweep", "--polish", str(SWEEP_POLISH_STEPS), "--arch",
                 "separable", "--dtype", "float64", "--r-values", *SWEEP_R,
                 "--device", "cuda", "--out", pkl])
        wall = time.time() - t0
        counts = _all_launches(*mods)
        r, e = _eint_errors(pkl)
        per_r = counts["separable_bwd"] / len(r)
        print(f"cli sweep --polish: {wall:.1f} s, {wall / len(r):.2f} s per "
              f"R; K1-fwd {counts['separable_fwd']}, K1-bwd "
              f"{counts['separable_bwd']} ({per_r:.1f} a polish) ({card})")
        for ri, v in zip(r, e):
            print(f"  R = {ri}: E_int - exact {v:+.6f} mHa")
        if not all(EINT_BAND[0] <= v <= EINT_BAND[1] for v in e) or \
                counts["separable_fwd"] <= 0 or counts["separable_bwd"] <= 0:
            raise AssertionError(f"21c: errors {e} mHa, launches {counts}")
        sys.stdout.flush()

        phase(f"21d cli sweep (the residual family, make train's model "
              f"flags: GZ + alpha, step schedule, float32, {N_TRAIN} points "
              f"a model, M = {len(SWEEP_R)}; {SWEEP_EPOCHS} epochs)")
        kept, real = {}, sweep.train_per_r_vmapped

        def keep(*a, **k):
            kept["out"] = real(*a, **k)
            return kept["out"]

        sweep.train_per_r_vmapped = keep
        try:
            _reset(*mods)
            t0 = time.time()
            run_cli(["sweep", "--gz", "--trainable-exponent",
                     "--lr-schedule", "step", "--r-values", *SWEEP_R,
                     "--epochs", str(SWEEP_EPOCHS), "--device", "cuda",
                     "--out", os.path.join(work, "sweep.pkl")])
            wall = time.time() - t0
        finally:
            sweep.train_per_r_vmapped = real
        counts = _all_launches(*mods)
        out = kept["out"]
        m = len(SWEEP_R)
        print(f"cli sweep: {wall:.1f} s, {SWEEP_EPOCHS / wall:.2f} steps/s "
              f"of the family ({m * SWEEP_EPOCHS / wall:.2f} model-steps/s); "
              f"launches {counts} ({counts['train_fwd'] / SWEEP_EPOCHS:.2f} "
              f"K2-fwd and {counts['train_bwd'] / SWEEP_EPOCHS:.2f} K2-bwd a "
              f"step) ({card})")
        print(f"  loss at step 0 {out['loss_history'][0]} -> best "
              f"{out['best_loss']}; E_net {out['E_net']}")
        want = dict.fromkeys(counts, 0)
        want.update(train_fwd=m * SWEEP_EPOCHS, train_bwd=m * SWEEP_EPOCHS)
        if counts != want:
            raise AssertionError(f"21d launches: {counts}")
        if not (np.isfinite(out["loss_history"]).all()
                and (out["best_loss"] < out["loss_history"][0]).all()):
            raise AssertionError("21d: a model's loss is not finite or not "
                                 "lower")
        sys.stdout.flush()
    finally:
        shutil.rmtree(work, ignore_errors=True)


# phase 22 (slice 12): the remaining entry points. The dispersion study's
# cut R set (the full 39 R run outside this script), and the bounds of the
# FMA ceiling: above 105% of the H100's 67 TFLOP/s the kernel is broken
DISPERSION_R = (0.2, 0.6, 1.0, 2.0, 3.0, 4.0)
BENCH_N, BENCH_STEPS, BENCH_PROFILE_STEPS = 100_000, 100, 5
PALLAS_TRAIN_AB_STEPS = 50
# the sharded quadrature's launches: 192 x-slabs of 192^2 points, whole
# slabs up to energy.CHUNK_POINTS a launch
SCALING_STEPS, SCALING_QUAD_N = 20, 192
AB_CHECK_N = 4096                  # pallas_ab's checked slice (its check_n)
# The ceiling chains at the bench's own shape against their plain versions,
# normwise (max |err| / max |plain|). Both maps contract, |dx'/dx| <= a =
# 0.9999. FMA: each step of the two paths rounds by at most 1.5 ulp of
# |x| < 2^-6 (the attractor b / (1 - a) = 0.01), so each of the 8 chains
# is off by at most 1.5 * 2^-30 / (1 - a) = 1.4e-5 against a sum of
# 0.08: 1.4e-3. tanh: a step rounds by at most ~5 ulp relative (the
# multiply and tanhf's 2 ulp on each path), summed over 8 192 steps with no
# damping: 2.5e-3. An element read or written wrong is off by O(1).
CEILING_FULL_TOL = {"fma": 2e-3, "tanh": 5e-3}


def _planted(params: dict) -> dict:
    """The controls' planted fault: the NN's output weights 0.1% off."""
    return dict(params, out=dict(params["out"],
                                 w=params["out"]["w"] * 1.001))


def _bench_profile(bench, arch: str) -> dict:
    """torch.profiler over a short run of the bench's measurement of
    ``arch``: the device time by kernel."""
    _, _, by_kernel = profile_device(
        lambda: bench.measure_ours(BENCH_N, BENCH_PROFILE_STEPS, "float32",
                                   arch, repeats=1),
        1, f"bench measurement of {arch} ({2 * BENCH_PROFILE_STEPS} steps "
           "and its setup)")
    return by_kernel


def entry_points_phase(dev, card: str) -> None:
    """Phase 22 (slice 12): cli bench, the graft entry and its dry run,
    and the benchmarks/ scripts, each through its own entry point, the
    launch counts set to 0 just before each and read just after."""
    import pickle

    import numpy as np
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import (
        bench, config, graft_entry)
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import (
        energy, plots)
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.benchmarks import (
        dispersion, pallas_ab, pallas_train_ab, ref_recipe_score, scaling)
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import ceiling
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_residual as k3
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_train as kt
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops.sampling \
        import sample_batch
    mods = (ks, kt, k3)
    cpu = torch.device("cpu")

    def launched(label, counts, want):
        """Exact launch counts where ``want`` gives a number, at least one
        where it gives True."""
        bad = {k: counts[k] for k, v in want.items()
               if (counts[k] < 1 if v is True else counts[k] != v)}
        print(f"  {label}: launches {counts}")
        if bad:
            raise AssertionError(f"{label}: launches {bad}, want "
                                 f"{ {k: want[k] for k in bad} }")

    work = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    try:
        phase(f"22a cli bench at its defaults (both families, float32, "
              f"{BENCH_N} points, {BENCH_STEPS} steps, best of 3; {card})")
        _reset(*mods)
        t0 = time.time()
        line, _ = run_cli(["bench"])
        wall = time.time() - t0
        steps = 4 * BENCH_STEPS            # the warm-up and 3 timed chunks
        launched("cli bench", _all_launches(*mods), {
            "train_fwd": steps, "train_bwd": steps, "separable_fwd": steps,
            "separable_bwd": steps, "train_bwd_pg": 0,
            "separable_bwd_pg": 0, "residual_fwd": 0})
        sep = line["separable"]
        rates = (line["value"], sep["points_per_sec"])
        if not (all(np.isfinite(rates)) and min(rates) > 0):
            raise AssertionError(f"cli bench: points/s {rates}")
        if not (0 < line["peak_fraction"] and 0 < sep["peak_fraction"]):
            raise AssertionError(f"cli bench: peak_fraction "
                                 f"{line['peak_fraction']}, "
                                 f"{sep['peak_fraction']}")
        if not line["ceiling_fma_gflops"] <= 1.05 * bench.H100_FP32_PEAK / 1e9:
            raise AssertionError(f"FMA ceiling {line['ceiling_fma_gflops']} "
                                 "GFLOP/s above 105% of 67 TFLOP/s")
        print(f"cli bench: {wall:.1f} s; symmetric (K2) {line['value']:.1f} "
              f"points/s, separable (K1) {sep['points_per_sec']:.1f} "
              f"points/s; peak_fraction {line['peak_fraction']} / "
              f"{sep['peak_fraction']} of the measured FMA ceiling "
              f"{line['ceiling_fma_gflops']} GFLOP/s ({card})")
        # float32 K1 at the bench line's batch of the separable step (the
        # flagship's weights) against its plain versions, and its times
        sep_cfg = config.Config(model=config.ModelConfig(arch="separable"))
        mc_kernel_check(ks, ansatz.from_jax_params(
            _load_npz_params(os.path.join(HERE, "artifacts",
                                          "flagship_separable.npz")),
            dtype="float32", device=dev), sep_cfg.model, sample_batch(
                torch.Generator(device=dev).manual_seed(0), sep_cfg,
                BENCH_N, device=dev), card, where="bench line")
        for arch, want in (("symmetric", "train_"),
                           ("separable", "separable_")):
            rows = [k for k in _bench_profile(bench, arch)
                    if want in k and "GateSource" not in k]
            print(f"  profiler kernel rows of {arch}: {rows}")
            if len(rows) < 2:
                raise AssertionError(f"the profile of the {arch} bench "
                                     f"shows no forward and backward "
                                     f"{want} kernels: {rows}")
        # the ceiling chains against their plain versions (a small size)
        gen = torch.Generator(device=dev).manual_seed(0)
        x0 = torch.rand(4096, generator=gen, device=dev)
        errs = {}
        for which in ("fma", "tanh"):
            got = ceiling.chain_cuda(x0, 4, 0.9999, 1e-6, which)
            want = ceiling.chain_plain(x0, 4, 0.9999, 1e-6, which)
            errs[which] = check_close(f"ceiling {which}", got, want, 1e-5,
                                      1e-6)[0]
        # ... and at the shape the bench line measures them
        sizes = bench.CEILING_SIZES["cuda"]
        x0 = torch.rand(sizes["n"], generator=gen, device=dev)
        errs_full = {}
        for which in ("fma", "tanh"):
            iters = sizes[f"iters_{which}"]
            got = ceiling.chain_cuda(x0, iters, 0.9999, 1e-6, which)
            want = ceiling.chain_plain(x0, iters, 0.9999, 1e-6, which)
            errs_full[which] = check_normwise(
                f"ceiling {which} at n {sizes['n']}, {iters} iterations",
                got, want, CEILING_FULL_TOL[which])[1]
        del x0, got, want
        ceil = bench.measure_ceilings("cuda")
        print("ceiling: " + json.dumps({
            "source": f"{PKG}/csrc/ceiling.cu", "card": card,
            "fma_tflops": ceil["fma_flops_per_sec"] / 1e12,
            "tanh_tops": ceil["tanh_ops_per_sec"] / 1e12,
            "of_the_fp32_peak": ceil["fma_flops_per_sec"]
            / bench.H100_FP32_PEAK,
            "max_abs_err_vs_plain": errs,
            "normwise_err_vs_plain_at_the_bench_shape": errs_full,
            "sizes": {k: ceil[k] for k in ("n", "iters_fma", "iters_tanh",
                                           "chains", "unroll_fma",
                                           "unroll_tanh")}}), flush=True)

        phase("22b graft_entry.entry() on the card against the host CPU "
              "(separable, float32, 8 192 points)")
        fn, (params, batch) = graft_entry.entry()
        _reset(*mods)
        got = [float(v) for v in fn(params, batch)]
        launched("entry()", _all_launches(*mods), {
            "separable_fwd": 1, "separable_bwd": 0, "train_fwd": 0})
        want = [float(v) for v in fn(
            ansatz.as_params(params, torch.float32, cpu),
            type(batch)(*(a.cpu() for a in batch)))]
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        print(f"entry(): (l, l_pde, l_bc) {got} on the card, {want} on the "
              f"host; relative {rel}")
        if not max(rel) <= 1e-4:
            raise AssertionError(f"entry(): card against host {rel}")

        phase("22c dryrun_multichip(1) (NCCL at world size 1)")
        _reset(*mods)
        d = graft_entry.dryrun_multichip(1)
        print(f"dryrun_multichip(1): {d}")
        launched("dryrun_multichip(1)", _all_launches(*mods), {
            "train_fwd": True, "train_bwd": True, "separable_fwd": True,
            "separable_bwd": True})

        phase("22d benchmarks pallas_ab and pallas_train_ab (both models) "
              "at their defaults")
        _reset(*mods)
        rep = pallas_ab.main()
        launched("pallas_ab", _all_launches(*mods), {
            "residual_fwd": 20 * 21 + 1, "train_fwd": 0})
        if not rep["max_abs_diff"] <= pallas_ab.DIFF_BOUND:
            raise AssertionError(f"pallas_ab: {rep['max_abs_diff']}")
        # the control: the same slice through the fwdlap pass with the
        # planted fault, against K3; it must read above the bound
        cfg_ab, p_ab, *pts = pallas_ab.inputs(rep["n"], dev)
        pts = [a[:AB_CHECK_N] for a in pts]
        with torch.no_grad():
            want = k3.psi_lap_pallas(p_ab, cfg_ab.model, *pts)
            s, _ = ansatz.psi_fwdlap(_planted(p_ab), cfg_ab.model, *pts)
        control = max(float((want[0] - s.v[..., 0]).abs().max()),
                      float((want[1] - s.l[..., 0]).abs().max()))
        print(f"pallas_ab: max_abs_diff {rep['max_abs_diff']:.3e}, bound "
              f"{pallas_ab.DIFF_BOUND}, planted fault {control:.3e} ({card})")
        if not control > pallas_ab.DIFF_BOUND:
            raise AssertionError(f"pallas_ab: the planted fault reads "
                                 f"{control:.3e}, within the bound")
        for model in ("flagship", "parity"):
            _reset(*mods)
            out = pallas_train_ab.main(model=model)
            launched(f"pallas_train_ab --model {model}", _all_launches(*mods),
                     {"train_fwd": 2 * PALLAS_TRAIN_AB_STEPS,
                      "train_bwd": 2 * PALLAS_TRAIN_AB_STEPS,
                      "separable_fwd": 0, "residual_fwd": 0})
            if not out["loss_rel_dev"] <= pallas_train_ab.LOSS_REL_BOUND:
                raise AssertionError(f"pallas_train_ab: {out}")

        def planted_loss(params, *args, **kw):
            return pallas_train_ab.fwdlap_loss(_planted(params), *args, **kw)

        class Planted(pallas_train_ab.FwdlapTrainer):
            loss = staticmethod(planted_loss)

        sound = pallas_train_ab.FwdlapTrainer
        pallas_train_ab.FwdlapTrainer = Planted
        try:
            control = pallas_train_ab.main(model="flagship")["loss_rel_dev"]
        finally:
            pallas_train_ab.FwdlapTrainer = sound
        print(f"pallas_train_ab --model flagship: bound "
              f"{pallas_train_ab.LOSS_REL_BOUND}, planted fault in the "
              f"fwdlap side {control:.3e} ({card})")
        if not control > pallas_train_ab.LOSS_REL_BOUND:
            raise AssertionError(f"pallas_train_ab: the planted fault reads "
                                 f"{control:.3e}, within the bound")

        phase(f"22e benchmarks scaling at its defaults on one card ({card})")
        _reset(*mods)
        out = scaling.main()
        launched("scaling", _all_launches(*mods), {
            "train_fwd": 4 * SCALING_STEPS, "train_bwd": 4 * SCALING_STEPS,
            "residual_fwd": True})
        if [r["devices"] for r in out["rows"]] != [1] or not np.isfinite(
                out["quadrature"]["E_int"]):
            raise AssertionError(f"scaling: {out}")

        phase(f"22f benchmarks dispersion at full width (n_xi 40, n_eta 24, "
              f"300 steps, float64) at R = {DISPERSION_R}")
        _reset(*mods)
        t0 = time.time()
        try:
            dispersion.main(r_values=DISPERSION_R, out_dir=work)
        except plots.MatplotlibMissing:
            if plots.have_matplotlib():
                raise
            print("  (no matplotlib on this host: the figure is not drawn; "
                  "the pickle was written before it)")
        wall = time.time() - t0
        launched("dispersion", _all_launches(*mods), {
            "separable_fwd": True, "separable_bwd": True, "train_fwd": True,
            "train_bwd": True})
        with open(os.path.join(work, "dispersion.pkl"), "rb") as f:
            sweeps = pickle.load(f)
        for label, out in sweeps.items():
            err = 1e3 * (out["E_net"] - energy.exact_energy_ode(out["R"]))
            print(f"  {label}: E - exact (mHa) "
                  + ", ".join(f"R={r:g} {e:+.6f}"
                              for r, e in zip(out["R"], err)))
            hi = EINT_BAND[1] if label.startswith("separable") else np.inf
            if not np.all((err >= EINT_BAND[0]) & (err <= hi)):
                raise AssertionError(f"dispersion {label}: {err}")
        print(f"dispersion: {wall:.1f} s for {2 * len(DISPERSION_R)} "
              f"polished R ({wall / (2 * len(DISPERSION_R)):.2f} s an R; "
              f"{card})")

        phase("22g benchmarks ref_recipe_score on phase 15's cut make "
              "ref-recipe checkpoint, on the card and on the host CPU")
        root = os.path.join(KEEP_DIR, "ref_recipe")
        _reset(*mods)
        rows = ref_recipe_score.main(root=root)
        launched("ref_recipe_score", _all_launches(*mods),
                 {"residual_fwd": 39, "train_fwd": 0, "separable_fwd": 0})
        host = ref_recipe_score.main(root=root, device="cpu")
        if len(rows) != 1 or len(host) != 1:
            raise AssertionError(f"ref_recipe_score: {rows}, {host}")
        diff = {k: abs(rows[0][k] - host[0][k]) for k in rows[0]
                if k != "run"}
        print(f"ref_recipe_score, card against host: max |diff| "
              f"{max(diff.values()):.3e} mHa ({diff})")
        if not max(diff.values()) <= 1e-9:
            raise AssertionError(f"ref_recipe_score: {diff}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# phase 23: bfloat16. A bfloat16 build stores in bfloat16 and computes in
# float32, rounding each output once, so it is held against its plain
# version run in float32 on the same bfloat16-rounded inputs, normwise:
# psi and lap psi within one bfloat16 unit roundoff (2^-8 = 3.9e-3: one
# rounding of the float32 result, float32's own error far below), the
# cotangents within two (the float32 sums of the partials in their own
# order, then one rounding). Beside it, psi and lap psi against the plain
# path computing in bfloat16 itself (every op rounded: about eight units)
# (the larger of that and the plain path's own error plus one unit) and
# against the plain version in float64 on the same rounded inputs (about
# four units). The distance to float64 on the unrounded inputs is
# printed, not held: rounding a point near a nucleus to bfloat16 moves
# lap psi there by 7% of its largest value (K1 at the flagship batch on an
# H100; PERF.md), which no build can undo. The cotangents' distance
# to float64 is printed too.
BF16_OUT_TOL, BF16_COT_TOL = 4e-3, 8e-3
BF16_PLAIN_TOL, BF16_F64_TOL = 3e-2, 1.5e-2
# 23c's cut runs: make train's and the separable trainer's steps, the
# fine-tune's, the Monte-Carlo trainer's (1 048 576 points a step), the
# polish's Adam and L-BFGS steps at the flagship grid, and --mesh 1's
BF16_TRAIN_STEPS, BF16_FT_STEPS, BF16_SEP_STEPS = 300, 100, 100
BF16_MC_STEPS, BF16_ADAM_STEPS, BF16_LBFGS_STEPS = 20, 20, 5
BF16_MESH_STEPS = 20
# the quotients of `cli evaluate --table-knots 0` at the default R domain:
# 77 distillation targets (R 0.2..4 by 0.05) and the 39-R surface
BF16_EVAL_QUOTIENTS = 77 + 39
# cli evaluate in a process of its own, printing its launch counts last
# (the E-head fit holds a host core over a minute in bfloat16: it starts
# after 23b's times and 23c's rates, and runs beside the last checks)
BF16_EVAL_DRIVER = (
    "import json, sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "from pinn_for_quantum_wavefunction_surfaces_tpu_torch import cli\n"
    "from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import "
    "pallas_residual, pallas_separable, pallas_train\n"
    "cli.main(sys.argv[2:])\n"
    "print(json.dumps({k: v for m in (pallas_separable, pallas_train, "
    "pallas_residual) for k, v in m.launches.items()}))\n")


def bf16_kernel_check(label, fwd, bwd, plain, vjp, ws64, args64, kw, gen,
                      names, pg=True):
    """One bfloat16 build (fwd; and bwd, with and without point gradients,
    unless None) against its plain versions: see BF16_OUT_TOL. Returns
    (worst abs error against the float32 reference, per output kind)."""
    import torch
    bf = torch.bfloat16
    wsb = [w.to(bf) for w in ws64]
    argsb = [a.to(bf) for a in args64]
    ws32, args32 = [w.float() for w in wsb], [a.float() for a in argsb]
    psi, lap = fwd(wsb, *argsb, **kw)
    ws_r64 = [w.double() for w in wsb]
    args_r64 = [a.double() for a in argsb]
    with torch.no_grad():
        ref = plain(ws32, *args32, **kw)
        in_bf16 = plain(wsb, *argsb, **kw)
        f64 = plain(ws_r64, *args_r64, **kw)
        unrounded = plain(ws64, *args64, **kw)
    torch.cuda.synchronize()
    if psi.dtype != bf:
        raise AssertionError(f"{label}: the build returned {psi.dtype}")
    err = {"fwd": 0.0}
    line = []
    for nm, got, r, b, t, u in zip(("psi", "lap"), (psi, lap), ref, in_bf16,
                                   f64, unrounded):
        e = check_normwise(f"{label} {nm} (float32 reference)", got, r,
                           BF16_OUT_TOL)
        # the plain path in bfloat16 is itself up to 4.5e-2 off the float32
        # reference (K3's ragged batch on an H100; PERF.md): the build must
        # then be no farther from it than that error and one rounding
        own = float((b.double() - r.double()).abs().max()
                    / r.double().abs().max())
        e_b = check_normwise(f"{label} {nm} (plain path in bfloat16)", got,
                             b, max(BF16_PLAIN_TOL, own + BF16_OUT_TOL))
        e_t = check_normwise(f"{label} {nm} (float64)", got, t,
                             BF16_F64_TOL)
        far = float((got.double() - u).abs().max() / u.abs().max())
        err["fwd"] = max(err["fwd"], e[0])
        line.append(f"{nm} {e[1]:.3e} (bf16 path {e_b[1]:.3e}, its own "
                    f"{own:.3e}; float64 {e_t[1]:.3e}, unrounded inputs "
                    f"{far:.3e})")
    print(f"{label} fwd: " + "; ".join(line))
    if bwd is None:
        return err
    n = args64[-1].numel()
    dpsi, dlap = (torch.randn(n, generator=gen, device=args64[0].device,
                              dtype=torch.float64).to(bf) for _ in range(2))
    for point_grads in ((False, True) if pg else (False,)):
        tag = "bwd_pg" if point_grads else "bwd"
        nms = names + (["x", "y", "z", "r"] if point_grads else [])

        def flat(out):
            return list(out[0]) + list(out[1:])

        got = flat(bwd(wsb, *argsb, dpsi, dlap, point_grads=point_grads,
                       **kw))
        again = flat(bwd(wsb, *argsb, dpsi, dlap, point_grads=point_grads,
                         **kw))
        with torch.no_grad():
            ref = flat(vjp(ws32, *args32, dpsi.float(), dlap.float(),
                           point_grads=point_grads, **kw))
            f64 = flat(vjp(ws_r64, *args_r64, dpsi.double(),
                           dlap.double(), point_grads=point_grads, **kw))
        torch.cuda.synchronize()
        if any(u.dtype != bf for u in got):
            raise AssertionError(f"{label} {tag}: not bfloat16 outputs")
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            raise AssertionError(f"{label} {tag}: two launches differ")
        errs = [check_normwise(f"{label} {tag} {nm}", u, v, BF16_COT_TOL)
                for nm, u, v in zip(nms, got, ref)]
        far = max(float((u.double() - v).abs().max() / v.abs().max())
                  for u, v in zip(got, f64))
        err[tag] = max(e[0] for e in errs)
        print(f"{label} {tag}: worst normwise {max(e[1] for e in errs):.3e} "
              f"(float64: {far:.3e}, printed); two launches bitwise equal")
    return err


def bf16_phase(dev, card: str) -> list[dict]:
    """Phase 23: the bfloat16 builds of K1, K2 and K3 against their plain
    versions, their times beside the float32 builds', and every entry
    point under --dtype bfloat16 through cli.main with its launches
    counted. Returns the bfloat16 entries of the kernels line."""
    import pickle

    import numpy as np
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
        checkpoint
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_residual as k3
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_train as kt
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops.sampling \
        import sample_batch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        variational
    bf = torch.bfloat16
    mods = (ks, kt, k3)
    work = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    ref_ckpt = os.path.join(KEEP_DIR, "ref_recipe", f"s{REF_SEED}", "stage2",
                            "finetune.npz")
    sep_art = os.path.join(HERE, "artifacts", "flagship_separable.npz")

    def artifact(name):
        return _load_npz_params(os.path.join(HERE, "artifacts", name))

    evals = {}
    try:
        phase("23a bfloat16 builds against their plain versions (K1 at the "
              f"flagship batch, K2 at {N_TRAIN} make train points, K3 at "
              f"{K3_N_UNIFORM} and {K3_N_RAGGED} points)")
        gen = torch.Generator(device=dev).manual_seed(23)
        timing = {}
        err = {}
        cfg = config.Config(model=config.ModelConfig(arch="separable"),
                            dtype="float64")
        vb = variational.dual_grid_vbatch(cfg, N_R, N_XI, N_ETA, device=dev)
        params = ansatz.from_jax_params(artifact("flagship_separable.npz"),
                                        dtype="float64", device=dev)
        rr = vb.r[:, None].expand_as(vb.x).reshape(-1)
        with torch.no_grad():
            a = ansatz.orbital_exponent(params, rr)
            b = ansatz.gz_exponent(params, rr, 1, a)
        args = (a, b, vb.x.reshape(-1), vb.y.reshape(-1), vb.z.reshape(-1),
                rr)
        ws = ks.kernel_weights(params, torch.float64)
        err["K1"] = bf16_kernel_check(
            f"K1 bfloat16 n={rr.numel()}", ks.separable_fwd_cuda,
            ks.separable_bwd_cuda, ks.psi_lap_separable_plain,
            ks.psi_lap_separable_vjp_plain, ws, args, {}, gen, K1_GRADS)
        timing["K1"] = (ws, args, {}, rr.numel())
        for label, name, p_sym in (("flagship", "flagship.npz", 1),
                                   ("ungerade_2psu", "ungerade_2psu.npz",
                                    -1)):
            mcfg = config.ModelConfig(inversion_symmetry=p_sym, gz=True,
                                      trainable_exponent=True)
            params = ansatz.from_jax_params(artifact(name), dtype="float64",
                                            device=dev)
            batch = sample_batch(gen, config.Config(model=mcfg), n=N_TRAIN,
                                 dtype=torch.float64, device=dev)
            with torch.no_grad():
                a = ansatz.orbital_exponent(params, batch.r)
                b = ansatz.gz_exponent(params, batch.r, p_sym, a)
                g = ansatz.gate(params, batch.r)
            ws = kt.kernel_weights(params, mcfg, torch.float64)
            args = (a, b, g, batch.x, batch.y, batch.z, batch.r)
            e = bf16_kernel_check(
                f"K2 bfloat16 {label} n={N_TRAIN}", kt.train_fwd_cuda,
                kt.train_bwd_cuda, kt.psi_lap_train_plain,
                kt.psi_lap_train_vjp_plain, ws, args, dict(p_sym=p_sym), gen,
                K2_GRADS)
            if label == "flagship":
                err["K2"], timing["K2"] = e, (ws, args, dict(p_sym=1),
                                              N_TRAIN)
        rng = np.random.default_rng(K3_SEED + 23)
        params = ansatz.from_jax_params(k3_weights(), dtype="float64",
                                        device=dev)
        for n in (K3_N_UNIFORM, K3_N_RAGGED):
            pts = [torch.as_tensor(rng.uniform(-18.0, 18.0, n), device=dev)
                   for _ in range(3)]
            r = torch.as_tensor(rng.uniform(0.2, 4.0, n), device=dev)
            ws = k3.kernel_weights(params, config.ModelConfig(),
                                   torch.float64)
            e = bf16_kernel_check(
                f"K3 bfloat16 n={n} R per point", k3.residual_fwd_cuda, None,
                k3.psi_lap_residual_plain, None, ws, (*pts, r), {}, gen, [])
            if n == K3_N_UNIFORM:
                err["K3"], timing["K3"] = e, (ws, (*pts, r), {}, n)
        sys.stdout.flush()

        phase(f"23b bfloat16 times (CUDA events, {card})")
        times = {}
        cases = (("K1", "separable", ks.separable_fwd_cuda,
                  ks.separable_bwd_cuda, ks.psi_lap_separable_plain,
                  ks.psi_lap_separable_vjp_plain),
                 ("K2", "train", kt.train_fwd_cuda, kt.train_bwd_cuda,
                  kt.psi_lap_train_plain, kt.psi_lap_train_vjp_plain),
                 ("K3", "residual", k3.residual_fwd_cuda, None,
                  k3.psi_lap_residual_plain, None))
        for kern, stem, fwd, bwd, plain, vjp in cases:
            ws, args, kw, n = timing[kern]
            h = ws[0].shape[1]
            by_type = {dt: ([w.to(dt) for w in ws], [t.to(dt) for t in args])
                       for dt in (bf, torch.float32)}
            dcot = torch.randn(n, generator=gen, device=dev,
                               dtype=torch.float64)
            whiches = ("fwd",) if bwd is None else ("fwd", "bwd", "bwd_pg")
            for which in whiches:
                t = {}
                for dt in (bf, torch.float32):
                    w_, a_ = by_type[dt]
                    c = dcot.to(dt)
                    if which == "fwd":
                        t[dt] = cuda_ms(lambda: fwd(w_, *a_, **kw),
                                        label=f"{kern} {which}")
                    else:
                        t[dt] = cuda_ms(lambda: bwd(
                            w_, *a_, c, c, point_grads=which == "bwd_pg",
                            **kw), label=f"{kern} {which}")
                w_, a_ = by_type[bf]
                c = dcot.to(bf)
                with torch.no_grad():
                    plain_ms = (cuda_ms(lambda: plain(w_, *a_, **kw), reps=2,
                                        label=f"{kern} {which} plain")
                                if which == "fwd" else cuda_ms(
                        lambda: vjp(w_, *a_, c, c,
                                    point_grads=which == "bwd_pg", **kw),
                        reps=2, label=f"{kern} {which} plain"))
                b_ms, b_by = bound_ms(n, h, "bfloat16", which, kern)
                times[(kern, which)] = dict(ms=t[bf], plain_ms=plain_ms,
                                            bound_ms=b_ms, bound_by=b_by)
                print(f"{kern}-{which} n={n} H={h}: bfloat16 {t[bf]:.4f} ms, "
                      f"float32 {t[torch.float32]:.4f} ms (ratio "
                      f"{t[bf] / t[torch.float32]:.3f}), plain in bfloat16 "
                      f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
                      flush=True)

        phase("23c the entry points under --dtype bfloat16 (cli.main; "
              "launches counted)")
        counts = {}

        def launched(label, want):
            got = _all_launches(*mods)
            bad = {k: got[k] for k, v in want.items()
                   if (got[k] < 1 if v is True else got[k] != v)}
            others = {k: v for k, v in got.items() if v and k not in want}
            print(f"  {label}: launches {dict((k, v) for k, v in got.items() if v)}")
            if bad or others:
                raise AssertionError(f"{label}: launches {bad or others}, "
                                     f"want {want}")
            for k, v in got.items():
                counts[k] = counts.get(k, 0) + v

        def hist(path, key="Ltot"):
            with open(path, "rb") as f:
                return np.asarray(pickle.load(f)[key], np.float64)

        make_train = ["--gz", "--trainable-exponent", "--lr-schedule",
                      "step", "--n-train", str(N_TRAIN)]
        # warm-up: the first steps pay one-time host costs
        run_cli(["train", *make_train, "--epochs", "5", "--dtype",
                 "bfloat16", "--out", os.path.join(work, "warm")])
        rates = {}
        for dtype in ("float32", "bfloat16"):
            out = os.path.join(work, f"train_{dtype}")
            _reset(*mods)
            res, _ = run_cli(["train", *make_train, "--epochs",
                              str(BF16_TRAIN_STEPS), "--dtype", dtype,
                              "--out", out])
            rates[dtype] = BF16_TRAIN_STEPS / res["runtime_s"]
            if dtype == "bfloat16":
                launched("cli train --dtype bfloat16 (make train)", {
                    "train_fwd_bf16": BF16_TRAIN_STEPS,
                    "train_bwd_bf16": BF16_TRAIN_STEPS})
                ltot = hist(os.path.join(out, "history.pkl"))
                if not (np.isfinite(ltot).all()
                        and res["best_loss"] < ltot[0]):
                    raise AssertionError(f"bfloat16 training: best "
                                         f"{res['best_loss']}, first "
                                         f"{ltot[0]}")
                print(f"  loss {ltot[0]:.6e} -> best {res['best_loss']:.6e}")
        print(f"cli train at make train's configuration: bfloat16 "
              f"{rates['bfloat16']:.2f} steps/s, float32 "
              f"{rates['float32']:.2f} steps/s ({card})")
        out = os.path.join(work, "finetune")
        _reset(*mods)
        res, _ = run_cli(["finetune",
                          os.path.join(HERE, "artifacts", "flagship.npz"),
                          "--epochs", str(BF16_FT_STEPS), "--n-train",
                          str(N_TRAIN), "--dtype", "bfloat16", "--out", out])
        launched("cli finetune --dtype bfloat16", {
            "train_fwd_bf16": BF16_FT_STEPS, "train_bwd_bf16": 0})
        ltot = hist(os.path.join(out, "history_finetune.pkl"))
        if not (np.isfinite(ltot).all() and res["best_loss"] < ltot[0]):
            raise AssertionError(f"bfloat16 fine-tune: {res}, {ltot[0]}")
        # --mesh 1 (NCCL at world size 1) against no mesh, bit for bit
        finals = {}
        for mesh in ("0", "1"):
            out = os.path.join(work, f"mesh{mesh}")
            run_cli(["train", *make_train, "--epochs", str(BF16_MESH_STEPS),
                     "--dtype", "bfloat16", "--mesh", mesh, "--out", out])
            with np.load(os.path.join(out, "final.npz")) as z:
                finals[mesh] = {k: z[k].tobytes() for k in z.files
                                if k != "__meta__"}
        if finals["0"] != finals["1"]:
            raise AssertionError("bfloat16 cli train --mesh 1 differs from "
                                 "one device")
        print(f"  cli train --mesh 1 --dtype bfloat16: {len(finals['1'])} "
              "leaves equal to one device's bit for bit")
        out = os.path.join(work, "separable")
        _reset(*mods)
        res, _ = run_cli(["train", "--arch", "separable", "--n-train",
                          str(N_TRAIN), "--epochs", str(BF16_SEP_STEPS),
                          "--dtype", "bfloat16", "--out", out])
        launched("cli train --arch separable --dtype bfloat16", {
            "separable_fwd_bf16": BF16_SEP_STEPS,
            "separable_bwd_bf16": BF16_SEP_STEPS})
        print(f"  {BF16_SEP_STEPS / res['runtime_s']:.2f} steps/s")
        for kern, name, fw, bw in (
                ("K2", "flagship.npz", "train_fwd_bf16", "train_bwd_bf16"),
                ("K1", "flagship_separable.npz", "separable_fwd_bf16",
                 "separable_bwd_bf16")):
            _reset(*mods)
            res, _ = run_cli(["variational",
                              os.path.join(HERE, "artifacts", name),
                              "--dtype", "bfloat16", "--epochs",
                              str(BF16_MC_STEPS), "--antithetic",
                              "--stratified-r", "--lr", str(MC_LR), "--out",
                              os.path.join(work, f"mc_{kern}")])
            launched(f"cli variational {name} --dtype bfloat16 (Monte "
                     f"Carlo, {MC_N_R * MC_N_PTS} points a step)",
                     {fw: BF16_MC_STEPS, bw: BF16_MC_STEPS})
            if not np.isfinite(res["E_mean_final"]):
                raise AssertionError(f"bfloat16 MC: {res}")
            print(f"  {res['points_per_sec']:.4e} points/s")
        _reset(*mods)
        t0 = time.time()
        run_cli(["variational", "--arch", "separable", "--spheroidal",
                 "--dtype", "bfloat16", "--n-r", str(N_R), "--n-xi",
                 str(N_XI), "--n-eta", str(N_ETA), "--adam-warmup",
                 str(BF16_ADAM_STEPS), "--lbfgs", str(BF16_LBFGS_STEPS),
                 "--out", os.path.join(work, "polish")])
        launched("cli variational --spheroidal --dtype bfloat16 (cut "
                 "polish)", {"separable_fwd_bf16": True,
                             "separable_bwd_bf16": True})
        print(f"  {time.time() - t0:.1f} s")
        # cli evaluate of both checkpoints in processes of their own, once
        # every time and rate above is taken: their E-head fits hold two
        # host cores while the checks below run
        for label, src in (("K1", sep_art), ("K3", ref_ckpt)):
            out = os.path.join(work, f"evaluate_{label}")
            evals[label] = (time.time(), subprocess.Popen(
                [sys.executable, "-c", BF16_EVAL_DRIVER, HERE, "evaluate",
                 src, "--dtype", "bfloat16", "--steps", "20",
                 "--table-knots", "0", "--out", out],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        # point gradients: autograd in x, y, z, R through both entry points
        for kern, params, mcfg, batch_of in (
                ("K1", artifact("flagship_separable.npz"),
                 config.ModelConfig(arch="separable"), "flagship"),
                ("K2", artifact("flagship.npz"),
                 config.ModelConfig(gz=True, trainable_exponent=True),
                 "make train")):
            p = ansatz.from_jax_params(params, dtype="bfloat16", device=dev)
            if kern == "K1":
                v = variational.dual_grid_vbatch(
                    config.Config(model=mcfg, dtype="bfloat16"), N_R, N_XI,
                    N_ETA, device=dev)
                pts = [v.x.reshape(-1), v.y.reshape(-1), v.z.reshape(-1),
                       v.r[:, None].expand_as(v.x).reshape(-1)]
                entry = ks.psi_lap_train_separable
            else:
                bt = sample_batch(gen, config.Config(model=mcfg), n=N_TRAIN,
                                  dtype=bf, device=dev)
                pts = [bt.x, bt.y, bt.z, bt.r]
                entry = kt.psi_lap_train
            pts = [t.detach().clone().requires_grad_(True) for t in pts]
            _reset(*mods)
            psi, lap, _ = entry(p, mcfg, *pts, point_grads=True)
            grads = torch.autograd.grad(
                (psi.float() ** 2).sum() + lap.float().sum(), pts)
            torch.cuda.synchronize()
            stem = "separable" if kern == "K1" else "train"
            launched(f"{kern} point gradients ({batch_of} batch, "
                     f"bfloat16)", {f"{stem}_fwd_bf16": 1,
                                    f"{stem}_bwd_pg_bf16": 1})
            if not all(bool(torch.isfinite(g).all()) for g in grads):
                raise AssertionError(f"{kern} bfloat16 point gradients")
        # cli energy: bfloat16 scores as float32, bit for bit
        pkl = {}
        for dtype in ("float32", "bfloat16"):
            pkl[dtype] = os.path.join(work, f"energy_{dtype}.pkl")
            _reset(*mods)
            run_cli(["energy", ref_ckpt, "--dtype", dtype, "--out",
                     pkl[dtype]])
            launched(f"cli energy --dtype {dtype}", {"residual_fwd": 39})
        with open(pkl["float32"], "rb") as f32, \
                open(pkl["bfloat16"], "rb") as f16:
            if f32.read() != f16.read():
                raise AssertionError("cli energy --dtype bfloat16 differs "
                                     "from --dtype float32")
        print("  cli energy: --dtype bfloat16 equals --dtype float32 bit "
              "for bit (39 float32 K3 launches each)")
        for label, (t0, proc) in evals.items():
            stdout, stderr = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"cli evaluate ({label}) exited "
                                     f"{proc.returncode}:\n{stderr[-3000:]}")
            lines = stdout.strip().splitlines()
            res, got = json.loads(lines[-2]), json.loads(lines[-1])
            fw = "separable_fwd_bf16" if label == "K1" else \
                "residual_fwd_bf16"
            bad = {k: v for k, v in got.items()
                   if v != (BF16_EVAL_QUOTIENTS if k == fw else 0)}
            walls = [ln for ln in stderr.splitlines() if "wall" in ln]
            print(f"  cli evaluate --dtype bfloat16 ({label}): "
                  f"{time.time() - t0:.1f} s; {walls[-1] if walls else ''};"
                  f" fit_rms {res['fit_rms_mHa']} mHa, mean_err "
                  f"{res['mean_err_mHa']}, max_err {res['max_err_mHa']}; "
                  f"launches {dict((k, v) for k, v in got.items() if v)}")
            if bad or not np.isfinite(res["mean_err_mHa"]):
                raise AssertionError(f"cli evaluate ({label}): {bad}, {res}")
            counts[fw] = counts.get(fw, 0) + got[fw]
        print(f"bfloat16 launches over phase 23c: {counts}")
        sys.stdout.flush()
    finally:
        for _, proc in evals.values():
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(work, ignore_errors=True)

    entries = []
    for kern, which, name, line, src in (
            ("K1", "fwd", "separable_fwd", "pallas_separable.py:293",
             "separable_fwd.cu"),
            ("K1", "bwd", "separable_bwd", "pallas_separable.py:325",
             "separable_bwd.cu"),
            ("K1", "bwd_pg", "separable_bwd_pg", "pallas_separable.py:325",
             "separable_bwd.cu"),
            ("K2", "fwd", "train_fwd", "pallas_train.py:233", "train_fwd.cu"),
            ("K2", "bwd", "train_bwd", "pallas_train.py:264", "train_bwd.cu"),
            ("K2", "bwd_pg", "train_bwd_pg", "pallas_train.py:264",
             "train_bwd.cu"),
            ("K3", "fwd", "residual_fwd", "pallas_residual.py:200",
             "residual_fwd.cu")):
        entries.append({
            "name": f"{name}_bf16",
            "route": "cuda",
            "source": f"{PKG}/csrc/{src}",
            "replaces": ("pinn_for_quantum_wavefunction_surfaces_tpu/ops/"
                         + line),
            "launches": counts.get(f"{name}_bf16", 0),
            "dtype": "bfloat16",
            "max_abs_err": err[kern][which],
            **times[(kern, which)],
            "library_ms": None,
        })
    return entries


# python3 chip_smoke.py --mesh N: the --mesh paths across N cards (NCCL)
# against one card, at make train's batch and the flagship grid (n_r 40
# splits over 2 and 4 ranks)
MULTI_N_TRAIN, MULTI_N_R, MULTI_SWEEP_N_TRAIN = 100_000, 40, 20_000
MULTI_TRAIN_STEPS, MULTI_ADAM_STEPS, MULTI_LBFGS_STEPS = 20, 40, 30
MULTI_SWEEP_EPOCHS = 50


def _quotients_job(mesh, n: int) -> dict:
    """One rank's rayleigh_quotient_sharded of ``_quotient_cases`` at R = 1
    on the uniform n^3 grid."""
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
        energy
    return {label: energy.rayleigh_quotient_sharded(p, c, 1.0, mesh, n=n)
            for label, (p, c) in _quotient_cases(mesh.device).items()}


def _rel_err(got, want) -> float:
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def multi_device_phase(n: int, card: str, device: str = "cuda") -> None:
    """--mesh N on N devices, each path against the same run on one: cli
    train (float64: the all-reduced sums change only the order of
    summation), the polish's Adam warmup and then its sharded L-BFGS, the
    sharded quotient, and cli sweep's model-parallel family. The ranks
    print their own lines; the results are read from their files."""
    import pickle

    import numpy as np
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import cli, config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
        energy
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.parallel import \
        mesh as pmesh
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        variational
    dev = torch.device(device)
    work = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    errors = {}

    def both(label, flags, read):
        """``flags`` through the CLI with --mesh 0 and --mesh n: what
        ``read(out)`` gives for each, and the wall times."""
        got = {}
        for mesh in ("0", str(n)):
            out = os.path.join(work, f"{label}{mesh}")
            t0 = time.time()
            cli.main(flags + ["--mesh", mesh, "--out", out,
                              "--device", device])
            sys.stdout.flush()
            print(f"  {label} --mesh {mesh}: {time.time() - t0:.1f} s "
                  f"({card})", flush=True)
            got[mesh] = read(out)
        return got["0"], got[str(n)]

    try:
        phase(f"M1 cli train --mesh {n} against one device (make train's "
              f"model, float64, {MULTI_N_TRAIN} points, "
              f"{MULTI_TRAIN_STEPS} steps)")

        def history(out):
            with open(os.path.join(out, "history.pkl"), "rb") as f:
                return pickle.load(f)["Ltot"]

        one, many = both("train", [
            "train", "--gz", "--trainable-exponent", "--lr-schedule", "step",
            "--dtype", "float64", "--n-train", str(MULTI_N_TRAIN),
            "--epochs", str(MULTI_TRAIN_STEPS)], history)
        errors["train losses"] = _rel_err(many, one)

        phase(f"M2 cli variational --spheroidal --mesh {n} against one "
              f"device ({MULTI_ADAM_STEPS} Adam steps at the flagship grid, "
              f"n_r {MULTI_N_R}), then {MULTI_LBFGS_STEPS} sharded L-BFGS "
              "steps")
        grid = ["variational", "--arch", "separable", "--spheroidal",
                "--n-r", str(MULTI_N_R), "--n-xi", "40", "--n-eta", "24",
                "--dtype", "float64", "--adam-warmup", str(MULTI_ADAM_STEPS)]

        def polished(out):
            return _load_npz_params(os.path.join(out, "variational.npz"))

        one, many = both("polish", grid, polished)
        # normwise by array: the zero-initialised output layers' entries
        # are tiny
        errors["polish params after Adam"] = max(
            float(np.max(np.abs(many[k][f] - one[k][f]))
                  / max(float(np.max(np.abs(one[k][f]))), 1e-300))
            for k in one for f in one[k])
        cfg = config.Config(model=config.ModelConfig(arch="separable"),
                            dtype="float64")
        vb = variational.dual_grid_vbatch(cfg, MULTI_N_R, 40, 24, device=dev)
        out = os.path.join(work, "lbfgs")
        cli.main(grid + ["--lbfgs", str(MULTI_LBFGS_STEPS), "--mesh", str(n),
                         "--out", out, "--device", device])
        with torch.no_grad():
            losses = [float(variational.quotient_loss(ansatz.from_jax_params(
                p, device=dev), cfg, vb)[0])
                for p in (one, polished(out))]
        print(f"  the objective after Adam {losses[0]:.12f}, after the "
              f"sharded L-BFGS {losses[1]:.12f}")
        if not losses[1] < losses[0]:
            raise AssertionError(f"M2: the sharded L-BFGS did not lower the "
                                 f"objective: {losses}")

        phase(f"M3 rayleigh_quotient_sharded on {n} devices against one "
              "(R = 1, n = 80)")
        got = pmesh.launch(_quotients_job, n, device=device, args=(80,))
        for label, (p, c) in _quotient_cases(dev).items():
            want = energy.rayleigh_quotient(p, c, 1.0, n=80)
            errors[f"quotient {label}"] = _rel_err(got[label], want)
            print(f"  {label}: {got[label]:.15f} against {want:.15f}")

        phase(f"M4 cli sweep --mesh {n} against one device (the family of "
              f"4 models, make train's model, float64, "
              f"{MULTI_SWEEP_N_TRAIN} points a model, {MULTI_SWEEP_EPOCHS} "
              "epochs)")

        def family(out):
            with open(out, "rb") as f:
                d = pickle.load(f)
            return np.concatenate([d["best_loss"], d["E_net"]])

        one, many = both("sweep", [
            "sweep", "--gz", "--trainable-exponent", "--lr-schedule", "step",
            "--dtype", "float64", "--n-train", str(MULTI_SWEEP_N_TRAIN),
            "--epochs", str(MULTI_SWEEP_EPOCHS), "--r-values", *SWEEP_R],
            lambda out: family(out))
        errors["sweep best losses and E heads"] = _rel_err(many, one)

        phase(f"M5 dryrun_multichip({n}) (the sharded step and polish "
              "against one device, the JAX dry run's tolerances)")
        from pinn_for_quantum_wavefunction_surfaces_tpu_torch import \
            graft_entry
        print(f"  {graft_entry.dryrun_multichip(n, device=device)}")

        phase(f"M6 benchmarks scaling at its defaults on 1 to {n} devices "
              f"({card})")
        from pinn_for_quantum_wavefunction_surfaces_tpu_torch.benchmarks \
            import scaling
        out = scaling.main(device=device)
        if max(r["devices"] for r in out["rows"]) != n:
            raise AssertionError(f"scaling rows: {out['rows']}")
        for k, v in errors.items():
            print(f"  {k}: max relative difference {v:.3e}")
        bad = {k: v for k, v in errors.items() if not v <= 1e-8}
        if bad:
            raise AssertionError(f"--mesh {n} differs from one device: {bad}")

        bf16_mesh_phase(n, card, device, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def bf16_mesh_phase(n: int, card: str, device: str, work: str) -> None:
    """M7: cli train --dtype bfloat16 --mesh n against one device (make
    train's model): the first step's loss (the same params and batch, the
    batch sums all-reduced in bfloat16 in another order) within 2e-2 of
    one device's, and the run finite and falling (later steps follow their
    own roundings)."""
    import pickle

    import numpy as np
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import cli
    phase(f"M7 cli train --mesh {n} --dtype bfloat16 against one device "
          f"(make train's model, {MULTI_N_TRAIN} points, "
          f"{MULTI_TRAIN_STEPS} steps)")
    hist = {}
    for mesh in ("0", str(n)):
        out = os.path.join(work, f"train_bf16_{mesh}")
        t0 = time.time()
        cli.main(["train", "--gz", "--trainable-exponent", "--lr-schedule",
                  "step", "--dtype", "bfloat16", "--n-train",
                  str(MULTI_N_TRAIN), "--epochs", str(MULTI_TRAIN_STEPS),
                  "--mesh", mesh, "--out", out, "--device", device])
        sys.stdout.flush()
        print(f"  --mesh {mesh}: {time.time() - t0:.1f} s ({card})",
              flush=True)
        with open(os.path.join(out, "history.pkl"), "rb") as f:
            hist[mesh] = np.asarray(pickle.load(f)["Ltot"], np.float64)
    one, many = hist["0"], hist[str(n)]
    first = abs(many[0] - one[0]) / abs(one[0])
    print(f"  first-step loss {many[0]:.6e} against {one[0]:.6e} "
          f"({first:.3e} relative); last {many[-1]:.6e} against "
          f"{one[-1]:.6e}")
    if not (np.isfinite(many).all() and first <= 2e-2
            and many[-1] < many[0]):
        raise AssertionError(f"M7: bfloat16 --mesh {n}: {many}")


def _same_arrays(label: str, got: dict, want: dict) -> None:
    """Two param trees with the same keys, dtypes and bits."""
    import numpy as np
    ok = sorted(got) == sorted(want) and all(
        sorted(got[k]) == sorted(want[k]) and all(
            np.asarray(got[k][f]).dtype == np.asarray(want[k][f]).dtype
            and np.array_equal(got[k][f], want[k][f]) for f in want[k])
        for k in want)
    if not ok:
        raise AssertionError(f"{label}: the arrays differ")
    print(f"  {label}: {sum(len(v) for v in want.values())} arrays equal "
          "bit for bit")


def _load_npz_params(path: str) -> dict:
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
        checkpoint
    tree, _ = checkpoint.load_params(path)
    return tree.get("params", tree)


# --k1-times: the MC trainer's steps a timed run (after a 5-step warm-up)
K1_TIMES_MC_STEPS = 50


def k1_times(root: str, card: str) -> None:
    """``python3 chip_smoke.py --k1-times ROOT``: the times of K1 built from
    the package under ROOT (this checkout, or a parent commit's package
    unpacked by `git archive` into a git-ignored directory of it), so that
    two builds are compared in one call (parent, change, change, parent):
    float32 K1-fwd, K1-bwd and K1-bwd-pg at the flagship batch (164 502
    points), the bench line's batch (100 000) and the MC batch (1 048 576),
    the bfloat16 and float64 builds at the flagship batch, each beside its
    bound; the separable MC step at the CLI's defaults (1 048 576 points)
    and the bench line's separable points/s; and the flagship's float64
    E_int at phase 4's four R in hex (equal bit for bit when float64 K1 is
    unchanged). Prints one JSON line."""
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import bench, config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
        energy
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
        checkpoint
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import _build
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops.sampling \
        import sample_batch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        variational
    if not os.path.abspath(ks.__file__).startswith(root + os.sep):
        raise AssertionError(f"--k1-times {root}: imported {ks.__file__}")
    dev = torch.device("cuda")
    t0 = time.time()
    _build.build(["separable_fwd", "separable_bwd"])
    print(f"K1 of {root} built in {time.time() - t0:.1f} s", flush=True)
    # the ground instantiations' registers and spills (the factor ones
    # apart): equal in two trees whose ground kernels compile alike
    ptxas = {name: sorted(f"{e['dtype']} H={e['h']}"
                          f"{' PG' if e['pg'] else ''}: {e['registers']} "
                          f"registers, {e['spill_stores']} B spill stores, "
                          f"{e['spill_loads']} B spill loads"
                          for e in ptxas_entries(
                              name, _build.log_path(name).read_text())
                          if not e["ex"])
             for name in ("separable_fwd", "separable_bwd")}
    src = os.path.join(HERE, "artifacts", "flagship_separable.npz")
    art, _ = checkpoint.load_params(src)
    art = art.get("params", art)
    cfg = config.Config(model=config.ModelConfig(arch="separable"),
                        dtype="float64")
    mcfg = cfg.model
    kw = dict(p_sym=mcfg.inversion_symmetry, ry=mcfg.ry, rz=mcfg.rz)
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg32 = config.Config(model=config.ModelConfig(arch="separable"))
    batches = {
        "flagship": variational.dual_grid_vbatch(cfg, N_R, N_XI, N_ETA,
                                                 device=dev),
        "bench": sample_batch(gen, cfg32, BENCH_N, device=dev),
        "MC": variational.sample_vbatch(gen, cfg32, MC_N_R, MC_N_PTS,
                                        antithetic=True, stratified=True)}
    out = {"root": root, "card": card, "times": {}, "ptxas": ptxas}
    with torch.no_grad():
        for bname, batch in batches.items():
            for dt in ((torch.float32, torch.bfloat16, torch.float64)
                       if bname == "flagship" else (torch.float32,)):
                params = ansatz.from_jax_params(art, dtype=dt, device=dev)
                rr = batch.r.to(dt)
                if batch.x.dim() == 2:
                    rr = rr[:, None].expand_as(batch.x).reshape(-1)
                pts = [t.reshape(-1).to(dt).contiguous()
                       for t in (batch.x, batch.y, batch.z)]
                a = ansatz.orbital_exponent(params, rr)
                b = ansatz.gz_exponent(params, rr, mcfg.inversion_symmetry,
                                       a)
                ws = ks.kernel_weights(params, dt)
                args = (a, b, *pts, rr.contiguous())
                n = rr.numel()
                dpsi = torch.randn(n, generator=gen, device=dev).to(dt)
                dlap = torch.randn(n, generator=gen, device=dev).to(dt)
                dt_name = str(dt)[6:]
                t = {"fwd": cuda_ms(lambda: ks.separable_fwd_cuda(
                         ws, *args, **kw), label="K1-fwd"),
                     "bwd": cuda_ms(lambda: ks.separable_bwd_cuda(
                         ws, *args, dpsi, dlap, **kw), label="K1-bwd"),
                     "bwd_pg": cuda_ms(lambda: ks.separable_bwd_cuda(
                         ws, *args, dpsi, dlap, point_grads=True, **kw),
                         label="K1-bwd-pg")}
                for which in ("fwd", "bwd", "bwd_pg"):
                    t[which + "_bound"] = bound_ms(n, ws[0].shape[1],
                                                   dt_name, which)[0]
                out["times"][f"{dt_name} {n}"] = t
                print(f"{dt_name} n={n}: " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in t.items()), flush=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_k1_times_")
    try:
        mc = ["variational", "--arch", "separable", src, "--n-r",
              str(MC_N_R), "--n-pts", str(MC_N_PTS), "--antithetic",
              "--stratified-r", "--lr", str(MC_LR), "--device", "cuda"]
        run_cli(mc + ["--epochs", "5", "--out", os.path.join(work, "w")])
        res, _ = run_cli(mc + ["--epochs", str(K1_TIMES_MC_STEPS), "--out",
                               os.path.join(work, "mc")])
        out["mc_steps_per_s"] = res["points_per_sec"] / (MC_N_R * MC_N_PTS)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    sep = bench.measure_ours(BENCH_N, BENCH_STEPS, "float32",
                             arch="separable")
    out["bench_separable_points_per_s"] = sep["points_per_sec"]
    out["bench_separable_points_per_s_median"] = sep["points_per_sec_median"]
    params64 = ansatz.from_jax_params(art, dtype="float64", device=dev)
    out["e_int_hex"] = [
        float(energy.rayleigh_quotient_spheroidal(params64, cfg, r)).hex()
        for r in (0.2, 1.0, 2.0, 4.0)]
    print("k1_times: " + json.dumps(out), flush=True)


# phase 25 (and --k1-factors): K1's excited-state factor instantiations at
# make excited-4fpiu's batch (n_r 39, the 64 x 32 dual grid: 78 rows of
# 3 645 = 284 310 points, float64 and float32), the 4f pi_u network
# against the plain version; the other factor families at one make
# evaluate quotient (96 x 96 at R = 1) in both types; then the cell's
# deflated Adam step (against pi_2ppu and pi_3ppu) captured
EXC4_N_XI, EXC4_N_ETA, EXC4_STEPS = 64, 32, 20
# (artifact, what its factors are): every factor of the epilogue, alone
# and together, in both sectors
K1_FACTOR_CASES = (
    ("pi_4fpiu", "angular node, m 1, wide alpha"),
    ("pi_3ppu", "radial node, m 1"),
    ("excited_3ssg", "two radial nodes"),
    ("excited_2ssg_legacynode", "legacy radial node"),
    ("excited_3dsg", "angular node"),
    ("delta_4fdu", "m 2, ungerade"),
    ("phi_4fpu", "m 3, ungerade"),
)


def _factor_case(name: str, dt, dev):
    """(params, cfg, factors) of a shipped excited artifact in type dt, its
    config as cli evaluate derives it."""
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
        checkpoint
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    path = os.path.join(HERE, "artifacts", name + ".npz")
    model, domain = excited_fields(checkpoint.load_meta(path))
    cfg = config.Config(model=config.ModelConfig(**model),
                        domain=config.DomainConfig(**domain),
                        dtype=str(dt)[6:])
    params = ansatz.from_jax_params(_load_npz_params(path), dtype=dt,
                                    device=dev)
    return params, cfg, ks.factors(params, cfg.model)


def k1_factor_check(label, params, cfg, batch, gen, times: bool):
    """K1's factor instantiations on ``batch`` against the plain version:
    float64: psi and lap psi against the plain version at K1's bounds
    (rtol 1e-12 and 1e-10, floors 1e-14 and 1e-12 of the larger of 1 and
    the largest |value|), the backward against autograd of it (every
    weight, a, b and each node head, normwise 1e-9). float32: both the
    kernel and the plain version against the plain version in float64 on
    the same inputs, the kernel within the larger of twice the plain
    version's own error and k1_f32_bounds' 1e-7 and 1e-5 of the largest
    |value| for psi and lap psi (normwise 1e-4 for the backward): on the 4f
    pi_u network the plain version in float32 is itself 1.3e-5 off float64
    in psi, above k1_f32_bounds' rtol. Two backward launches bit for bit; with
    ``times`` the CUDA-event times of both launches and of the ground
    launches on the same points (the factors dropped) beside the ground
    network's bound. Returns the times and errors."""
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    mcfg = cfg.model
    dt = batch.x.dtype
    dt_name = str(dt)[6:]
    fac = ks.factors(params, mcfg)
    rr = batch.r[:, None].expand_as(batch.x).reshape(-1).contiguous()
    pts = [t.reshape(-1).contiguous() for t in (batch.x, batch.y, batch.z)]
    n = rr.numel()
    with torch.no_grad():
        a, b, *nodes = ks.separable_heads(params, mcfg, rr)
    nodes = tuple(nodes) + (None,) * (3 - len(nodes))
    ws = ks.kernel_weights(params, dt)
    args = (a, b, *pts, rr)
    kw = dict(p_sym=mcfg.inversion_symmetry, ry=mcfg.ry, rz=mcfg.rz)
    kx = dict(kw, factors=fac, nodes=nodes)
    psi_k, lap_k = ks.separable_fwd_cuda(ws, *args, **kx)
    dpsi = torch.randn(n, generator=gen, device=psi_k.device, dtype=dt)
    dlap = torch.randn(n, generator=gen, device=psi_k.device, dtype=dt)
    names = K1_GRADS + [k for k, t in zip(("c1", "c2", "n0"), nodes)
                        if t is not None]

    def reference(wdt):
        """The plain forward and autograd's cotangents in type wdt on the
        inputs' values."""
        up = [w.to(wdt).requires_grad_(True) for w in ws]
        ab = [t.to(wdt).requires_grad_(True) for t in (a, b)]
        nd = tuple(None if t is None else t.to(wdt).requires_grad_(True)
                   for t in nodes)
        pp, ll = ks.psi_lap_separable_plain(
            up, *ab, *(t.to(wdt) for t in (*pts, rr)),
            **dict(kw, factors=fac, nodes=nd))
        leaves = up + ab + [t for t in nd if t is not None]
        g = torch.autograd.grad((pp * dpsi.to(wdt)).sum()
                                + (ll * dlap.to(wdt)).sum(), leaves)
        return pp.detach(), ll.detach(), g

    dws, da, db, dnd = ks.separable_bwd_cuda(ws, *args, dpsi, dlap, **kx)
    dws2, da2, db2, dnd2 = ks.separable_bwd_cuda(ws, *args, dpsi, dlap,
                                                 **kx)
    torch.cuda.synchronize()
    got = list(dws) + [da, db] + [t for t in dnd if t is not None]
    again = list(dws2) + [da2, db2] + [t for t in dnd2 if t is not None]
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise AssertionError(f"K1-bwd-ex {label}: two launches differ")
    if dt == torch.float64:
        psi_p, lap_p, ref = reference(dt)
        tol_psi = (1e-12, 1e-14 * max(1.0, float(psi_p.abs().max())))
        tol_lap = (1e-10, 1e-12 * max(1.0, float(lap_p.abs().max())))
        e_psi = check_close(f"K1-fwd-ex psi {label}", psi_k, psi_p,
                            *tol_psi)
        e_lap = check_close(f"K1-fwd-ex lap {label}", lap_k, lap_p,
                            *tol_lap)
        worst = max((check_normwise(f"K1-bwd-ex {nm} {label}", g, r_, 1e-9)
                     for nm, g, r_ in zip(names, got, ref)),
                    key=lambda e: e[1])
        fwd = (f"psi max abs {e_psi[0]:.3e} rel {e_psi[1]:.3e}, lap max abs "
               f"{e_lap[0]:.3e} rel {e_lap[1]:.3e}")
        out = {"fwd_err": max(e_psi[0], e_lap[0]), "bwd_err": worst[0]}
    else:
        psi_p, lap_p, ref_p = reference(dt)
        psi_t, lap_t, ref = reference(torch.float64)

        def off(x, want):
            return float((x.double() - want).abs().max()
                         / want.abs().max())

        fwd = []
        for nm, k_err, p_err, floor in (
                ("psi", off(psi_k, psi_t), off(psi_p, psi_t), 1e-7),
                ("lap", off(lap_k, lap_t), off(lap_p, lap_t), 1e-5)):
            if k_err > max(2.0 * p_err, floor):
                raise AssertionError(
                    f"K1-fwd-ex {nm} {label}: {k_err:.3e} off float64, the "
                    f"plain version in float32 {p_err:.3e}")
            fwd.append(f"{nm} {k_err:.3e} of max |value| off float64 (the "
                       f"plain version in float32 {p_err:.3e})")
        fwd = ", ".join(fwd)
        worst = (0.0, 0.0)
        for nm, g, rp, r_ in zip(names, got, ref_p, ref):
            scale = float(r_.norm())
            k_err = float((g.double() - r_).norm()) / scale
            p_err = float((rp.double() - r_).norm()) / scale
            if not k_err <= max(2.0 * p_err, 1e-4):
                raise AssertionError(
                    f"K1-bwd-ex {nm} {label}: {k_err:.3e} off float64, "
                    f"the plain version in float32 {p_err:.3e}")
            worst = max(worst, (k_err * scale, k_err), key=lambda e: e[1])
        out = {"fwd_err": float((psi_k.double() - psi_t).abs().max()),
               "bwd_err": worst[0]}
    print(f"K1 factors {fac} {label}: fwd {fwd}; bwd worst normwise "
          f"{worst[1]:.3e} (abs {worst[0]:.3e}); two launches bitwise equal",
          flush=True)
    if times:
        with torch.no_grad():
            t = {"fwd_ex": cuda_ms(lambda: ks.separable_fwd_cuda(
                     ws, *args, **kx), label="K1-fwd-ex"),
                 "bwd_ex": cuda_ms(lambda: ks.separable_bwd_cuda(
                     ws, *args, dpsi, dlap, **kx), label="K1-bwd-ex"),
                 "fwd": cuda_ms(lambda: ks.separable_fwd_cuda(
                     ws, *args, **kw), label="K1-fwd"),
                 "bwd": cuda_ms(lambda: ks.separable_bwd_cuda(
                     ws, *args, dpsi, dlap, **kw), label="K1-bwd")}
        for which in ("fwd", "bwd"):
            t[which + "_bound"], t[which + "_bound_by"] = bound_ms(
                n, ws[0].shape[1], dt_name, which)
        print(f"{dt_name} n={n} {label}: K1-fwd-ex {t['fwd_ex']:.4f} ms, "
              f"K1-bwd-ex {t['bwd_ex']:.4f} ms; ground launches on the same "
              f"points {t['fwd']:.4f} / {t['bwd']:.4f} ms; bound (the ground "
              f"network's operations) {t['fwd_bound']:.4f} / "
              f"{t['bwd_bound']:.4f} ms {t['fwd_bound_by']}", flush=True)
        out.update(t)
    return out


def k1_factor_phase(dev, card: str) -> dict:
    """Phase 25: K1's excited-state factor epilogue on the card (the EX
    instantiations: launch keys separable_fwd_ex and separable_bwd_ex), as
    the comment above K1_FACTOR_CASES says; their ptxas registers and
    spills beside the ground ones. Then the 4f pi_u cell's step: the
    deflated quotient's Adam warmup, captured, at the cell's batch from
    the shipped pi_4fpiu weights against pi_2ppu and pi_3ppu: one
    separable_fwd_ex and one separable_bwd_ex a step, nothing else, no
    point through the forward-Laplacian route, the loss finite. Returns
    the 4f pi_u times."""
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import _build
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import routing
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        variational

    phase(f"25 K1 factor epilogue (make excited-4fpiu's batch: n_r {N_R}, "
          f"{EXC4_N_XI} x {EXC4_N_ETA} dual grid; float64 and float32; "
          f"{card})")
    for name in ("separable_fwd", "separable_bwd"):
        for e in ptxas_entries(name, _build.log_path(name).read_text()):
            if e["ex"]:
                print(f"  {name} {e['dtype']} H={e['h']} EX: "
                      f"{e['registers']} registers; {e['spill']}")
    gen = torch.Generator(device=dev).manual_seed(25)
    out = {}
    for dt in (torch.float64, torch.float32):
        for name, what in K1_FACTOR_CASES:
            params, cfg, fac = _factor_case(name, dt, dev)
            if name == "pi_4fpiu":
                batch = variational.dual_grid_vbatch(
                    cfg, N_R, EXC4_N_XI, EXC4_N_ETA, device=dev, dtype=dt)
            else:
                batch = variational.spheroidal_vbatch(
                    cfg, n_r=1, n_xi=96, n_eta=96, r_values=[1.0],
                    device=dev, dtype=dt)
            res = k1_factor_check(f"{name} ({what}) {str(dt)[6:]} "
                                  f"n={batch.x.numel()}", params, cfg, batch,
                                  gen, times=name == "pi_4fpiu")
            if name == "pi_4fpiu":
                out[str(dt)[6:]] = res
    # the cell's captured step
    params, cfg, _ = _factor_case("pi_4fpiu", torch.float64, dev)
    vb = variational.dual_grid_vbatch(cfg, N_R, EXC4_N_XI, EXC4_N_ETA,
                                      device=dev)
    refs = [_factor_case(n, torch.float64, dev)[0]
            for n in ("pi_2ppu", "pi_3ppu")]
    loss_fn = variational.polish_objective(cfg, vb, refs)
    warm = variational.AdamWarmup(params, cfg, vb, 1500, 1.0,
                                  loss_fn=loss_fn)
    warm.advance()
    torch.cuda.synchronize()
    ks.reset_launches()
    fw = dict(routing.fwdlap_points)
    t0 = time.time()
    for _ in range(EXC4_STEPS):
        warm.advance()
    loss = float(warm.loss)
    wall = time.time() - t0
    counts = _nonzero(ks.launches)
    print(f"4fpiu deflated Adam warmup, {EXC4_STEPS} captured steps at "
          f"{vb.x.numel()} points: {EXC4_STEPS / wall:.2f} steps/s; "
          f"launches {counts}; forward-Laplacian points "
          f"{routing.fwdlap_points} (before {fw}); loss {loss:.9f} ({card})",
          flush=True)
    if counts != {"separable_fwd_ex": EXC4_STEPS,
                  "separable_bwd_ex": EXC4_STEPS} or \
            routing.fwdlap_points != fw or not math.isfinite(loss):
        raise AssertionError(f"25 4fpiu step: launches {counts}, "
                             f"fwdlap {routing.fwdlap_points}, loss {loss}")
    return out


# --step-times: make train's configuration for STEP_TIMES_TRAIN steps in
# chunks of STEP_TIMES_TRAIN_CHUNK, the Monte-Carlo trainer at the CLI's
# defaults for STEP_TIMES_MC steps a family in chunks of STEP_TIMES_MC_CHUNK,
# and the flagship polish's Adam warmup for STEP_TIMES_ADAM steps (it logs
# every 100): each rate between the run's first and last host reads, which
# leaves the first chunk's one-time costs out
STEP_TIMES_TRAIN, STEP_TIMES_TRAIN_CHUNK = 400, 100
STEP_TIMES_REF, STEP_TIMES_REF_CHUNK = 200, 50
STEP_TIMES_MC, STEP_TIMES_MC_CHUNK = 100, 25
STEP_TIMES_ADAM = 400


# Phase 26: the R-heads kernel pair (csrc/rheads.cuh) at make train's batch,
# its widths, the captured make train step and make ref-recipe's step
RHEADS_STEPS, RHEADS_CHUNK, RHEADS_RESAMPLE = 60, 20, 7
RHEADS_REF_STEPS = 20
RHEADS_PROFILE_STEPS = 10
# limits against the plain versions on the same inputs (normwise: each
# output and each gradient against its largest value): float32 against the
# float64 plain version, bfloat16 against the float32 plain version on the
# bfloat16-rounded inputs (phase 23a's); float64 elementwise below
RHEADS_F32_TOL = (1e-5, 1e-4)     # values, gradients
RHEADS_BF16_TOL = (4e-3, 8e-3)
RHEADS_NAMES = ("E", "alpha", "b", "gate")


def rheads_ops(he: int, hr: int, which: str) -> int:
    """Operations a point of the R heads (E of width he, rank-1 heads of hr
    units in all; a sigmoid 3, a tanh 1): the forward, and the backward
    with its recompute of the forward."""
    fwd = 2 * he * he + 11 * he + 7 * hr + 12
    return fwd if which == "fwd" else fwd + 4 * he * he + 15 * he + \
        16 * hr + 12


def _rheads_inputs(params, mcfg, r, dt):
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        rheads as rh
    kw = dict(p_sym=int(mcfg.inversion_symmetry),
              has_alpha="alpha1" in params, has_beta="beta1" in params)
    return rh.head_weights(params, dt), r.to(dt), kw


def rheads_check(label, ws, r, kw, gen, ref=None) -> dict:
    """The kernels against the plain versions: values, every weight
    gradient and dr under seeded cotangents (and with only E's cotangent,
    the fine-tune's), two backward launches bit for bit. ``ref``: the
    (ws, r) of the reference run in a wider type (float64 for float32,
    float32 for bfloat16), else the plain version in the kernel's type."""
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        rheads as rh
    dt = r.dtype
    n = r.shape[0]
    cots = [torch.randn(n, generator=gen, device=r.device,
                        dtype=torch.float64) for _ in range(4)]
    rws, rr = (ws, r) if ref is None else ref
    got = rh.rheads_fwd_cuda(ws, r, **kw)
    want = rh.rheads_plain(rws, rr, **kw)
    errs = {}
    for nm, g, w in zip(RHEADS_NAMES, got, want):
        if dt == torch.float64:
            errs[nm] = check_close(f"rheads_fwd {nm} {label}", g, w, 1e-12,
                                   1e-13 * float(w.abs().max()))[1]
        else:
            tol = RHEADS_F32_TOL[0] if dt == torch.float32 else \
                RHEADS_BF16_TOL[0]
            errs[nm] = check_normwise(f"rheads_fwd {nm} {label}",
                                      g.to(w.dtype), w, tol)[1]
    worst = 0.0
    for which, use in (("all", (0, 1, 2, 3)), ("E only", (0,))):
        c = [cots[i] if i in use else None for i in range(4)]
        args = [None if t is None else t.to(dt) for t in c]
        dws, dr = rh.rheads_bwd_cuda(ws, r, *args, r_grad=True, **kw)
        dws2, dr2 = rh.rheads_bwd_cuda(ws, r, *args, r_grad=True, **kw)
        if not all(torch.equal(u, v) for u, v in
                   zip(list(dws) + [dr], list(dws2) + [dr2])):
            raise AssertionError(f"rheads_bwd {label} ({which}): two launches "
                                 "differ")
        rargs = [None if t is None else t.to(dt).to(rr.dtype) for t in c]
        wdws, wdr = rh.rheads_vjp_plain(rws, rr, *rargs, r_grad=True, **kw)
        for i, (u, v) in enumerate(zip(list(dws) + [dr], list(wdws) + [wdr])):
            nm = f"rheads_bwd {'dr' if i == len(dws) else f'w{i}'} {label} " \
                 f"({which})"
            u = u.to(v.dtype)
            if dt == torch.float64:
                if i == len(dws):
                    e = check_close(nm, u, v, 1e-8,
                                    1e-10 * float(v.abs().max()))[1]
                else:
                    e = check_normwise(nm, u, v, 1e-8)[1]
            else:
                tol = RHEADS_F32_TOL[1] if dt == torch.float32 else \
                    RHEADS_BF16_TOL[1]
                e = check_normwise(nm, u, v, tol)[1]
            worst = max(worst, e)
    errs["bwd"] = worst
    print(f"  R heads {label}: fwd " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items() if k != "bwd") +
        f" | bwd worst {worst:.3e} (every weight gradient and dr; with all "
        "four cotangents and with E's alone); two launches bitwise equal",
        flush=True)
    return errs


def rheads_phase(dev, card: str) -> dict:
    """Phase 26: the R-heads kernel pair (``ops/rheads.py``,
    csrc/rheads.cuh in K2's libraries): ptxas registers and spills and the
    occupancy of each instantiation; at make train's batch (100 000 points
    of the port's sampler; flagship.npz at P = +1 and ungerade_2psu.npz at
    P = -1) the kernels against their plain versions in float64 (values
    rtol 1e-12, gradients and dr 1e-8), float32 and bfloat16 (the limits
    RHEADS_F32_TOL and RHEADS_BF16_TOL), two backward launches bit for bit;
    the other E widths (4, 8, 16) and the reference-parity model (no alpha
    or beta head) on a ragged 1 100-point batch in float64; CUDA-event
    times of both kernels beside the torch heads they replace and the
    bound; then make train captured against graph=False bit for bit with
    one rheads_fwd and one rheads_bwd a step beside K2's two launches, and
    make ref-recipe's step (float64, reference-parity) and its fine-tune
    (E alone trained) with their launches a step."""
    import dataclasses

    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
        checkpoint
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        _build, _cuda
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_residual as k3
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_train as kt
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        rheads as rh
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops.sampling \
        import sample_batch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        engine

    phase(f"26 R-heads kernel pair (E, alpha, b, gate at each of "
          f"{N_TRAIN} points; {card})")
    for name in ("train_fwd", "train_bwd"):
        entries = [e for e in ptxas_entries(name,
                                            _build.log_path(name).read_text())
                   if e["kernel"].startswith("rheads")]
        if len(entries) != 3 * len(_cuda.SUPPORTED_HIDDEN):
            raise AssertionError(f"{name}: {len(entries)} R-heads "
                                 "instantiations in the ptxas log")
        for e in entries:
            print(f"  {e['kernel']} {e['dtype']} He={e['h']}: "
                  f"{e['registers']} registers; {e['spill']}")
        kname = name.replace("train", "rheads")
        for dt in (torch.float64, torch.float32, torch.bfloat16):
            for he in _cuda.SUPPORTED_HIDDEN:
                blocks, smem = _cuda.occupancy(kname, he, dt, hidden_gate=10,
                                               lib=name)
                print(f"  {kname} {str(dt)[6:]} He={he} (rank-1 heads of 10):"
                      f" {smem} B shared memory a block of "
                      f"{rh.POINTS_PER_TILE} threads, {blocks} resident "
                      f"blocks per SM")

    def artifact(name):
        tree, _ = checkpoint.load_params(os.path.join(HERE, "artifacts",
                                                      name))
        return tree["params"]

    gen = torch.Generator(device=dev).manual_seed(26)
    out = {"card": card}
    for label, name, p_sym in (("flagship", "flagship.npz", 1),
                               ("ungerade_2psu", "ungerade_2psu.npz", -1)):
        mcfg = config.ModelConfig(inversion_symmetry=p_sym, gz=True,
                                  trainable_exponent=True)
        params = ansatz.from_jax_params(artifact(name), dtype="float64",
                                        device=dev)
        batch = sample_batch(gen, config.Config(model=mcfg), n=N_TRAIN,
                             dtype=torch.float64, device=dev)
        w64, r64, kw = _rheads_inputs(params, mcfg, batch.r, torch.float64)
        rheads_check(f"{label} float64", w64, r64, kw, gen)
        w32, r32, _ = _rheads_inputs(params, mcfg, batch.r, torch.float32)
        rheads_check(f"{label} float32", w32, r32, kw, gen,
                     ref=(tuple(w.double() for w in w32), r32.double()))
        wbf, rbf, _ = _rheads_inputs(params, mcfg, batch.r, torch.bfloat16)
        rheads_check(f"{label} bfloat16", wbf, rbf, kw, gen,
                     ref=(tuple(w.float() for w in wbf), rbf.float()))
        if label != "flagship":
            continue
        hr = sum(rh.widths(w64, True, True)[1:])
        for dt_name, ws, r in (("float64", w64, r64), ("float32", w32, r32),
                               ("bfloat16", wbf, rbf)):
            n = r.shape[0]
            cots = [torch.randn(n, generator=gen, device=dev,
                                dtype=torch.float64).to(r.dtype)
                    for _ in range(4)]
            f_ms = cuda_ms(lambda: rh.rheads_fwd_cuda(ws, r, **kw),
                           label=f"rheads_fwd {dt_name}")
            b_ms = cuda_ms(lambda: rh.rheads_bwd_cuda(ws, r, *cots,
                                                      r_grad=False, **kw),
                           label=f"rheads_bwd {dt_name}")
            pw = [w.clone().requires_grad_(True) for w in ws]

            def plain_step():
                outs = rh.rheads_plain(pw, r, **kw)
                torch.autograd.grad(outs, pw, cots, allow_unused=True)

            p_ms = cuda_ms(plain_step, reps=2, warmup=2,
                           label=f"torch heads {dt_name}")
            peak = PEAK_FP64_OTHER if dt_name == "float64" else PEAK_FP32
            bounds = {w: 1e3 * n * rheads_ops(ws[0].shape[1], hr, w)
                      / peak for w in ("fwd", "bwd")}
            out[dt_name] = dict(fwd_ms=f_ms, bwd_ms=b_ms, plain_ms=p_ms,
                                bound_fwd_ms=bounds["fwd"],
                                bound_bwd_ms=bounds["bwd"])
            print(f"  R heads {dt_name} at {n} points: rheads_fwd "
                  f"{f_ms:.4f} ms, rheads_bwd {b_ms:.4f} ms (bound "
                  f"{bounds['fwd']:.4f} / {bounds['bwd']:.4f} ms, operations; "
                  f"{100 * bounds['fwd'] / f_ms:.1f}% / "
                  f"{100 * bounds['bwd'] / b_ms:.1f}%); the torch heads, "
                  f"forward and backward: {p_ms:.4f} ms", flush=True)
    for he in (4, 8, 16):
        for p_sym in (1, -1):
            mcfg = config.ModelConfig(inversion_symmetry=p_sym, gz=True,
                                      trainable_exponent=True, hidden_e=he)
            params = ansatz.init_params(mcfg, seed=he, dtype="float64",
                                        device=dev)
            for k in ("alpha2", "beta2", "gate2", "eout"):
                params[k]["w"] = 0.5 * torch.randn(
                    params[k]["w"].shape, generator=gen, device=dev,
                    dtype=torch.float64)
            r = 0.2 + 3.8 * torch.rand(1100, generator=gen, device=dev,
                                       dtype=torch.float64)
            ws, r, kw = _rheads_inputs(params, mcfg, r, torch.float64)
            rheads_check(f"He={he} P={p_sym} n=1100 float64", ws, r, kw, gen)
    ref = config.ModelConfig()
    params = ansatz.init_params(ref, seed=1, dtype="float64", device=dev)
    r = 0.2 + 3.8 * torch.rand(1100, generator=gen, device=dev,
                               dtype=torch.float64)
    ws, r, kw = _rheads_inputs(params, ref, r, torch.float64)
    rheads_check("reference-parity (no alpha, no beta) n=1100 float64", ws,
                 r, kw, gen)

    mods = (ks, kt, k3, rh)
    tcfg = config.Config(model=config.ModelConfig(gz=True,
                                                  trainable_exponent=True))
    tcfg = tcfg.replace(train=dataclasses.replace(
        tcfg.train, lr_schedule="step", n_train=N_TRAIN,
        epochs=RHEADS_STEPS, scan_chunk=RHEADS_CHUNK,
        resample_every=RHEADS_RESAMPLE))
    runs = {}
    want = {k: RHEADS_STEPS for k in ("train_fwd", "train_bwd", "rheads_fwd",
                                      "rheads_bwd")}
    for graph in (True, False):
        _reset(*mods)
        runs[graph] = engine.train(tcfg, device=dev, graph=graph)
        torch.cuda.synchronize()
        counts = _nonzero(_all_launches(*mods))
        print(f"  make train {'captured' if graph else 'eager'}: launches "
              f"{counts} ({RHEADS_STEPS} steps)", flush=True)
        if counts != want:
            raise AssertionError(f"26 make train launches: {counts}, want "
                                 f"{want}")
    _same_history("26 make train", runs[True].history, runs[False].history)
    for name in ("params", "best_params", "ema_params"):
        _same_arrays(f"26 make train {name}", getattr(runs[True], name),
                     getattr(runs[False], name))
    print("  make train captured = eager bit for bit (history, params, best "
          "and EMA params)", flush=True)
    # the captured step's kernels: the pair once each, none of the torch
    # heads' products, dot products or sigmoids
    tgen = torch.Generator(device=dev).manual_seed(0)
    tr = engine.Trainer(tcfg, device=dev, generator=tgen)

    def sample(g):
        return sample_batch(g, tcfg, device=dev)

    tr.batch = sample(tgen)
    for _ in range(3):   # eager, capture, replay
        tr.advance(sample)
    _, busy, by_kernel = profile_device(lambda: tr.advance(sample),
                                        RHEADS_PROFILE_STEPS,
                                        "captured make train step")
    heads_ops = [k for k in by_kernel
                 if re.search("gemm|dot_kernel|sigmoid", k, re.I)]
    pair = {k: v for k, v in by_kernel.items() if "rheads_" in k}
    if heads_ops or len(pair) != 2:
        raise AssertionError(f"26 the step's kernels: the pair {list(pair)}, "
                             f"torch heads' ops {heads_ops}")
    print(f"  the pair in the step: " + ", ".join(
        f"{k.split('<')[0].split()[-1]} {v:.4f} ms" for k, v in pair.items())
        + f" of {busy:.4f} ms busy; no GEMM, dot or sigmoid kernel",
        flush=True)
    rcfg = config.Config(dtype="float64")
    rcfg = rcfg.replace(train=dataclasses.replace(
        rcfg.train, epochs=RHEADS_REF_STEPS, scan_chunk=RHEADS_REF_STEPS))
    _reset(*mods)
    res = engine.train(rcfg, device=dev)
    torch.cuda.synchronize()
    counts = _nonzero(_all_launches(*mods))
    print(f"  make ref-recipe (float64, reference-parity): launches "
          f"{counts} ({RHEADS_REF_STEPS} steps)", flush=True)
    if counts != {k: RHEADS_REF_STEPS for k in want}:
        raise AssertionError(f"26 ref-recipe launches: {counts}")
    fcfg = config.finetune_config(rcfg)
    fcfg = fcfg.replace(train=dataclasses.replace(
        fcfg.train, epochs=RHEADS_REF_STEPS, scan_chunk=RHEADS_REF_STEPS))
    _reset(*mods)
    engine.finetune(fcfg, res.best_params, device=dev)
    torch.cuda.synchronize()
    counts = _nonzero(_all_launches(*mods))
    print(f"  its fine-tune (E alone trained): launches {counts} "
          f"({RHEADS_REF_STEPS} steps)", flush=True)
    if counts != {k: RHEADS_REF_STEPS for k in ("train_fwd", "rheads_fwd",
                                                "rheads_bwd")}:
        raise AssertionError(f"26 fine-tune launches: {counts}")
    return out


def _between_reads(marks: list) -> float:
    """Steps/s between a run's first and last host reads, from its
    (step, time) marks at the chunk ends: the first chunk's one-time costs
    (the eager first step, the capture) stay out."""
    if len(marks) < 2:
        return float("nan")
    (s0, t0), (s1, t1) = marks[0], marks[-1]
    return (s1 - s0) / (t1 - t0)


def step_times(root: str, card: str) -> None:
    """``python3 chip_smoke.py --step-times ROOT``: the trainers' rates
    through the public entry points of the package under ROOT (this
    checkout, or a parent commit's package unpacked by `git archive` into a
    git-ignored directory of it), so that two commits are compared in one
    call (parent, change, change, parent): ``engine.train`` at make train's
    configuration and at make ref-recipe's (the reference-parity model in
    float64), ``train_variational`` at the CLI's defaults from both
    flagship artifacts, ``polish_spheroidal``'s Adam warmup at the
    flagship's grid, each in steps/s, and ``bench.measure_ours`` (the bench
    line's points/s, both families). The make train and ref-recipe losses
    and the warmup's last logged loss, in hex, show whether two commits
    take the same steps.
    Prints one JSON line."""
    import dataclasses

    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import bench, config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import _build
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        engine, variational
    if not os.path.abspath(engine.__file__).startswith(root + os.sep):
        raise AssertionError(f"--step-times {root}: imported "
                             f"{engine.__file__}")
    dev = torch.device("cuda")
    t0 = time.time()
    _build.build(list(_build.KERNELS))
    print(f"kernels of {root} built in {time.time() - t0:.1f} s", flush=True)
    out = {"root": root, "card": card}

    def mark(marks):
        return lambda step, *_: marks.append((step, time.time()))

    tcfg = config.Config(model=config.ModelConfig(gz=True,
                                                  trainable_exponent=True))
    tcfg = tcfg.replace(train=dataclasses.replace(
        tcfg.train, lr_schedule="step", n_train=N_TRAIN,
        epochs=STEP_TIMES_TRAIN, scan_chunk=STEP_TIMES_TRAIN_CHUNK))
    marks = []
    res = engine.train(tcfg, device=dev, log_cb=mark(marks))
    out["make_train_steps_per_s"] = _between_reads(marks)
    out["make_train_loss_hex"] = float(res.history["Ltot"][-1]).hex()
    # make ref-recipe's cli train: the reference-parity model in float64
    rcfg = config.Config(dtype="float64")
    rcfg = rcfg.replace(train=dataclasses.replace(
        rcfg.train, epochs=STEP_TIMES_REF, scan_chunk=STEP_TIMES_REF_CHUNK))
    marks = []
    res = engine.train(rcfg, device=dev, log_cb=mark(marks))
    out["ref_recipe_steps_per_s"] = _between_reads(marks)
    out["ref_recipe_loss_hex"] = float(res.history["Ltot"][-1]).hex()
    art = os.path.join(HERE, "artifacts")
    for name, src, mcfg in (
            ("separable", "flagship_separable.npz",
             config.ModelConfig(arch="separable")),
            ("symmetric", "flagship.npz",
             config.ModelConfig(gz=True, trainable_exponent=True))):
        cfg = config.Config(model=mcfg)
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, scan_chunk=STEP_TIMES_MC_CHUNK))
        params = ansatz.from_jax_params(
            _load_npz_params(os.path.join(art, src)), dtype="float32",
            device=dev)
        marks = []
        variational.train_variational(
            cfg, params=params, n_r=MC_N_R, n_pts=MC_N_PTS,
            epochs=STEP_TIMES_MC, lr=MC_LR, antithetic=True, stratified=True,
            log_cb=mark(marks), device=dev)
        out[f"mc_{name}_steps_per_s"] = _between_reads(marks)
    cfg = config.Config(model=config.ModelConfig(arch="separable"),
                        dtype="float64")
    init = ansatz.init_params(cfg.model, seed=cfg.train.seed,
                              dtype="float64", device=dev)
    marks, logged = [], []

    def log(i, m):
        marks.append((i, time.time()))
        logged.append(m["E_adam"])

    variational.polish_spheroidal(init, cfg, n_r=N_R, n_xi=N_XI,
                                  n_eta=N_ETA, steps=0,
                                  adam_steps=STEP_TIMES_ADAM, log_cb=log,
                                  device=dev)
    out["adam_warmup_steps_per_s"] = _between_reads(marks)
    out["adam_loss_hex"] = float(logged[-1]).hex()
    for arch in ("symmetric", "separable"):
        r = bench.measure_ours(BENCH_N, BENCH_STEPS, "float32", arch=arch)
        out[f"bench_{arch}_points_per_s"] = r["points_per_sec"]
        out[f"bench_{arch}_points_per_s_median"] = r["points_per_sec_median"]
    print("step_times: " + json.dumps(out), flush=True)


# --tracing: replays of a step graph timed a round, rounds a graph, host
# calls of advance timed a state, and make train's steps, the MC trainer's
# and the Adam warmup's in a run whose tracing is switched on at its first
# read (two chunks a run)
TRACING_REPLAYS, TRACING_ROUNDS, TRACING_CALLS = 200, 4, 200
TRACING_TRAIN, TRACING_MC, TRACING_ADAM = 500, 100, 200


def _replay_ms(graphs_: dict) -> dict:
    """{name: device ms a replay} of each CUDA graph, TRACING_ROUNDS rounds
    of TRACING_REPLAYS replays between CUDA events, the graphs taken in
    turn each round; the median round."""
    import numpy as np
    import torch
    times = {k: [] for k in graphs_}
    for _ in range(TRACING_ROUNDS):
        for k, g in graphs_.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            for _ in range(TRACING_REPLAYS):
                g.replay()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b) / TRACING_REPLAYS)
    return {k: float(np.median(v)) for k, v in times.items()}


def _advance_us(advance) -> float:
    """Median host µs of ``advance()``, each call begun with the device's
    queue drained."""
    import numpy as np
    import torch
    spans = []
    for _ in range(TRACING_CALLS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        advance()
        spans.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return 1e6 * float(np.median(spans))


def tracing_costs(card: str) -> None:
    """``python3 chip_smoke.py --tracing``: what the port's tracing
    (``utils/profiling.py``) costs, and that it changes no step, for make
    train's ``engine.Trainer``, the Monte-Carlo trainer (the flagship
    artifact, float32) and the polish's Adam warmup (float64, the
    flagship's dual grid), each at its recipe's batch:

    - device ms a replay of each step graph captured without the phase
      marks and with them (the graph of the other state held), in turn;
    - host µs of ``advance`` with the spans off and on (no profiler);
    - the phases of one step with tracing on;
    - ``engine.train``, ``train_variational`` and ``_adam_minimize`` with
      tracing switched on at their first read (the graphs captured again)
      against the same runs without: histories, logged losses and
      parameters equal bit for bit.

    Prints one JSON line."""
    import dataclasses

    import numpy as np
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import _build
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops.sampling \
        import sample_batch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        engine, variational
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.utils import \
        profiling
    dev = torch.device("cuda")
    _build.build(list(_build.KERNELS))
    out = {"card": card}
    tcfg = config.Config(model=config.ModelConfig(gz=True,
                                                  trainable_exponent=True))
    tcfg = tcfg.replace(train=dataclasses.replace(
        tcfg.train, lr_schedule="step", n_train=N_TRAIN, epochs=100_000,
        resample_frac=0.9))
    mcfg = config.Config(model=config.ModelConfig(arch="separable"))
    mc_params = ansatz.from_jax_params(_load_npz_params(os.path.join(
        HERE, "artifacts", "flagship_separable.npz")), dtype="float32",
        device=dev)
    pcfg = config.Config(model=config.ModelConfig(arch="separable"),
                         dtype="float64")
    p_params = ansatz.init_params(pcfg.model, seed=pcfg.train.seed,
                                  dtype="float64", device=dev)
    vb = variational.dual_grid_vbatch(pcfg, N_R, N_XI, N_ETA,
                                      dtype="float64", device=dev)

    def trainer():
        gen = torch.Generator(device=dev).manual_seed(0)
        tr = engine.Trainer(tcfg, device=dev, generator=gen)

        def sample(g):
            return sample_batch(g, tcfg, device=dev)

        tr.batch = sample(gen)
        return tr, lambda: tr.advance(sample), {
            "step": lambda: tr._step.graph,
            "sample": lambda: tr._sampler[1].graph}

    def monte_carlo():
        mc = variational.MonteCarloTrainer(
            mcfg, mc_params, MC_N_R, MC_N_PTS,
            torch.Generator(device=dev).manual_seed(0), antithetic=True,
            stratified=True, device=dev)
        return mc, mc.advance, {"step": lambda: mc._step.graph}

    def warmup():
        w = variational.AdamWarmup(p_params, pcfg, vb, 1500, 1.0)
        return w, w.advance, {"step": lambda: w._step.graph}

    for name, make in (("make_train", trainer), ("mc", monte_carlo),
                       ("adam_warmup", warmup)):
        tr, advance, graphs_of = make()
        for _ in range(3):
            advance()
        host_off = _advance_us(advance)
        plain = {k: g() for k, g in graphs_of.items()}
        profiling.enable(True)
        advance()                       # captured again, with the marks
        host_on = _advance_us(advance)
        phases = tr.phases()
        marked = {k: g() for k, g in graphs_of.items()}
        profiling.enable(False)
        times = _replay_ms({**{f"{k}_plain": g for k, g in plain.items()},
                            **{f"{k}_marked": g for k, g in marked.items()}})
        out[name] = {"replay_ms": times, "advance_host_us_off": host_off,
                     "advance_host_us_on": host_on, "phases_ms": phases}
        print(f"  {name}: {json.dumps(out[name])}", flush=True)
        del tr, advance, plain, marked
        torch.cuda.synchronize()

    def switch_at_first_read(log):
        def cb(step, metrics):
            log.append((step, dict(metrics)))
            profiling.enable(True)
        return cb

    def runs(run):
        """(logs, result) of ``run(log_cb)`` without tracing, then with
        tracing switched on at the first read."""
        got = []
        for switch in (False, True):
            log = []
            cb = switch_at_first_read(log) if switch else \
                (lambda step, m, log=log: log.append((step, dict(m))))
            res = run(cb)
            profiling.enable(False)
            got.append((log, res))
        return got

    def same(label, a, b):
        if isinstance(a, dict):
            for k in a:
                same(f"{label}.{k}", a[k], b[k])
        elif isinstance(a, np.ndarray) or np.isscalar(a):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise AssertionError(f"tracing switched on: {label} differs")
        else:
            raise TypeError(f"{label}: {type(a)}")

    def losses_only(log):
        return [{k: v for k, v in m.items() if not k.endswith("_ms")}
                for _, m in log]

    checks = {}
    tr_cfg = tcfg.replace(train=dataclasses.replace(
        tcfg.train, epochs=TRACING_TRAIN, scan_chunk=TRACING_TRAIN // 2))
    (l0, r0), (l1, r1) = runs(lambda cb: engine.train(tr_cfg, device=dev,
                                                      log_cb=cb))
    if not any(k.endswith("_ms") for k in l1[-1][1]):
        raise AssertionError("engine.train logged no phase ms with tracing "
                             "on")
    for k in r0.history:
        same(f"make_train.history.{k}", r0.history[k], r1.history[k])
    for part in ("params", "best_params", "ema_params"):
        same(f"make_train.{part}", getattr(r0, part), getattr(r1, part))
    checks["make_train"] = {"steps": TRACING_TRAIN, "logs": l1[-1][1],
                            "loss_hex": float(r0.history["Ltot"][-1]).hex()}
    mc_cfg = mcfg.replace(train=dataclasses.replace(
        mcfg.train, scan_chunk=TRACING_MC // 2))
    (l0, r0), (l1, r1) = runs(lambda cb: variational.train_variational(
        mc_cfg, params=mc_params, n_r=MC_N_R, n_pts=MC_N_PTS,
        epochs=TRACING_MC, lr=MC_LR, antithetic=True, stratified=True,
        log_cb=cb, device=dev))
    for k in r0.history:
        same(f"mc.history.{k}", r0.history[k], r1.history[k])
    same("mc.params", r0.params, r1.params)
    same("mc.ema_params", r0.ema_params, r1.ema_params)
    checks["mc"] = {"steps": TRACING_MC,
                    "loss_hex": float(r0.history["Ltot"][-1]).hex()}
    (l0, r0), (l1, r1) = runs(lambda cb: variational._adam_minimize(
        p_params, pcfg, vb, TRACING_ADAM, 1.0, log_cb=cb))
    if losses_only(l0) != losses_only(l1) or len(l0) != 2:
        raise AssertionError(f"adam warmup: logs {l0} against {l1}")
    same("adam_warmup.params", ansatz.to_numpy_params(r0),
         ansatz.to_numpy_params(r1))
    checks["adam_warmup"] = {"steps": TRACING_ADAM,
                             "loss_hex": float(l0[-1][1]["E_adam"]).hex()}
    out["switched_on_midway_equal"] = checks
    print("tracing: " + json.dumps(out), flush=True)


# phase 24: each captured path against its graph=False run, in one call.
# 24a: make train's configuration (GZ + alpha, step schedule, float32,
# N_TRAIN points) cut to CAPTURE_TRAIN_STEPS steps in chunks of
# CAPTURE_CHUNK, a resample every CAPTURE_RESAMPLE steps (so resamples, the
# frozen-batch cutoff at 0.9 of the run and chunk boundaries all fall
# inside it) and sc_step cut as the run is (make train's 3000 of 20 000:
# the rate changes inside it too), then its fine-tune; 24b: the
# Monte-Carlo trainer at the CLI's defaults (MC_N_R x MC_N_PTS, float32,
# antithetic, stratified) from both flagship artifacts, a chunk boundary
# every CAPTURE_MC_CHUNK steps; 24c: the flagship polish's Adam warmup (its
# dual grid, float64). Each path's idle share from the profiler over
# CAPTURE_PROFILE_STEPS steps after three (eager, capture, one replay)
CAPTURE_TRAIN_STEPS, CAPTURE_CHUNK, CAPTURE_RESAMPLE = 300, 100, 7
CAPTURE_SC_STEP = 45
CAPTURE_FINETUNE_STEPS, CAPTURE_FINETUNE_CHUNK = 100, 50
CAPTURE_MC_STEPS, CAPTURE_MC_CHUNK = 50, 20
CAPTURE_ADAM_STEPS = 100
CAPTURE_PROFILE_STEPS = 10


def _same_history(label: str, got: dict, want: dict) -> None:
    import numpy as np
    if sorted(got) != sorted(want) or not all(
            np.array_equal(got[k], want[k]) for k in want):
        raise AssertionError(f"{label}: the histories differ")


def _rates(label: str, steps: int, runs: dict, marks: dict) -> dict:
    """Steps/s of the captured and the eager run of one call: over the
    whole run (setup and capture included) and between its first and last
    host reads (the chunk ends), printed side by side."""
    out = {}
    for graph, res in runs.items():
        steady = _between_reads(marks[graph])
        out["captured" if graph else "eager"] = {
            "steps_per_s": steps / res.runtime_s,
            "steady_steps_per_s": steady}
    c, e = out["captured"], out["eager"]
    print(f"  {label}: captured {c['steps_per_s']:.2f} steps/s "
          f"(between host reads {c['steady_steps_per_s']:.2f}), eager "
          f"{e['steps_per_s']:.2f} ({e['steady_steps_per_s']:.2f}); "
          f"x{c['steady_steps_per_s'] / e['steady_steps_per_s']:.2f}",
          flush=True)
    return out


def _idle(label: str, make_advance) -> dict:
    """The profiler's wall, busy time and idle share a step of a live
    trainer, captured and eager: ``make_advance(graph)`` builds one and
    returns its step function; three steps first (the eager call, the
    capture and one replay)."""
    out = {}
    for graph in (True, False):
        advance = make_advance(graph)
        for _ in range(3):
            advance()
        wall, busy, _ = profile_device(
            advance, CAPTURE_PROFILE_STEPS,
            f"{label} step, {'captured' if graph else 'eager'}")
        out["captured" if graph else "eager"] = {
            "wall_ms": wall, "busy_ms": busy, "idle": 1.0 - busy / wall}
    return out


def captured_phase(dev, card: str) -> dict:
    """Phase 24: the trainers' captured steps (training/graphs.py) against
    the same runs with graph=False, bit for bit (losses, params, best loss
    and params, EMA, the batch after a resample), with exact launch counts
    (one forward and one backward launch a step; no backward in the
    fine-tune), steps/s of both from this call and the idle shares."""
    import dataclasses

    import numpy as np
    import torch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_residual as k3
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_separable as ks
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_train as kt
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops.sampling \
        import sample_batch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        engine, variational
    mods = (ks, kt, k3)
    summary = {"card": card}

    def run_both(label, fn, steps, want):
        """fn(graph, log_cb) -> result, for graph True then False, each
        with the launch counts reset before it and checked after it."""
        runs, marks = {}, {}
        for graph in (True, False):
            marks[graph] = []
            _reset(*mods)
            torch.cuda.synchronize()
            runs[graph] = fn(graph, lambda step, *_, m=marks[graph]:
                             m.append((step, time.time())))
            torch.cuda.synchronize()
            counts = _nonzero(_all_launches(*mods))
            print(f"  {label}, {'captured' if graph else 'eager'}: "
                  f"launches {counts} ({steps} steps)", flush=True)
            if counts != want:
                raise AssertionError(f"24 {label} launches: {counts}, want "
                                     f"{want}")
        return runs, marks

    phase(f"24a make train captured against graph=False (GZ + alpha, "
          f"float32, {N_TRAIN} points, {CAPTURE_TRAIN_STEPS} steps in "
          f"chunks of {CAPTURE_CHUNK}, a resample every {CAPTURE_RESAMPLE} "
          f"steps until step {int(0.9 * CAPTURE_TRAIN_STEPS)}), then "
          f"{CAPTURE_FINETUNE_STEPS} fine-tune steps ({card})")
    tcfg = config.Config(model=config.ModelConfig(gz=True,
                                                  trainable_exponent=True))
    tcfg = tcfg.replace(train=dataclasses.replace(
        tcfg.train, lr_schedule="step", n_train=N_TRAIN,
        epochs=CAPTURE_TRAIN_STEPS, scan_chunk=CAPTURE_CHUNK,
        resample_every=CAPTURE_RESAMPLE, sc_step=CAPTURE_SC_STEP))
    runs, marks = run_both(
        "make train",
        lambda g, cb: engine.train(tcfg, device=dev, graph=g, log_cb=cb),
        CAPTURE_TRAIN_STEPS, {"train_fwd": CAPTURE_TRAIN_STEPS,
                              "train_bwd": CAPTURE_TRAIN_STEPS})
    a, b = runs[True], runs[False]
    _same_history("24a make train", a.history, b.history)
    for name in ("params", "best_params", "ema_params"):
        _same_arrays(f"make train {name}", getattr(a, name),
                     getattr(b, name))
    if a.best_loss != b.best_loss or not all(
            torch.equal(u, v) for u, v in zip(a.state.batch, b.state.batch)):
        raise AssertionError("24a: the best loss or the last batch differs")
    loss = float(a.history["Ltot"][-1])
    print(f"  best loss, and the batch of the last resample, equal bit for "
          f"bit; Ltot after {CAPTURE_TRAIN_STEPS} steps {loss:.9e} "
          f"({loss.hex()})")
    summary["make_train"] = _rates("make train", CAPTURE_TRAIN_STEPS, runs,
                                   marks)
    summary["make_train"]["loss_hex"] = loss.hex()
    fcfg = config.finetune_config(tcfg)
    fcfg = fcfg.replace(train=dataclasses.replace(
        fcfg.train, epochs=CAPTURE_FINETUNE_STEPS,
        scan_chunk=CAPTURE_FINETUNE_CHUNK))
    ft, ft_marks = run_both(
        "fine-tune",
        lambda g, cb: engine.finetune(fcfg, a.best_params, device=dev,
                                      graph=g, log_cb=cb),
        CAPTURE_FINETUNE_STEPS, {"train_fwd": CAPTURE_FINETUNE_STEPS})
    _same_history("24a fine-tune", ft[True].history, ft[False].history)
    for name in ("params", "best_params", "ema_params"):
        _same_arrays(f"fine-tune {name}", getattr(ft[True], name),
                     getattr(ft[False], name))
    summary["finetune"] = _rates("fine-tune", CAPTURE_FINETUNE_STEPS, ft,
                                 ft_marks)

    def train_step(graph):
        gen = torch.Generator(device=dev).manual_seed(0)
        tr = engine.Trainer(tcfg, device=dev, generator=gen, graph=graph)

        def sample(g):
            return sample_batch(g, tcfg, device=dev)

        tr.batch = sample(gen)
        return lambda: tr.advance(sample)

    summary["make_train"]["profile"] = _idle("make train", train_step)

    phase(f"24b the Monte-Carlo trainer captured against graph=False "
          f"({MC_N_R} x {MC_N_PTS} points, float32, antithetic, "
          f"stratified, {CAPTURE_MC_STEPS} steps in chunks of "
          f"{CAPTURE_MC_CHUNK}) ({card})")
    art = os.path.join(HERE, "artifacts")
    for name, src, mcfg, key in (
            ("separable", "flagship_separable.npz",
             config.ModelConfig(arch="separable"), "separable"),
            ("symmetric", "flagship.npz",
             config.ModelConfig(gz=True, trainable_exponent=True),
             "train")):
        cfg = config.Config(model=mcfg)
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, scan_chunk=CAPTURE_MC_CHUNK))
        tree = _load_npz_params(os.path.join(art, src))

        def start():
            return ansatz.from_jax_params(tree, dtype="float32", device=dev)

        def mc(g, cb, _cfg=cfg):
            return variational.train_variational(
                _cfg, params=start(), n_r=MC_N_R, n_pts=MC_N_PTS,
                epochs=CAPTURE_MC_STEPS, lr=MC_LR, antithetic=True,
                stratified=True, log_cb=cb, device=dev, graph=g)

        runs, marks = run_both(f"MC {name}", mc, CAPTURE_MC_STEPS, {
            f"{key}_fwd": CAPTURE_MC_STEPS, f"{key}_bwd": CAPTURE_MC_STEPS})
        _same_history(f"24b MC {name}", runs[True].history,
                      runs[False].history)
        for field in ("params", "ema_params"):
            _same_arrays(f"MC {name} {field}", getattr(runs[True], field),
                         getattr(runs[False], field))
        summary[f"mc_{name}"] = _rates(f"MC {name}", CAPTURE_MC_STEPS, runs,
                                       marks)
        live = {}

        def mc_step(graph, _cfg=cfg):
            tr = variational.MonteCarloTrainer(
                _cfg, start(), MC_N_R, MC_N_PTS,
                torch.Generator(device=dev).manual_seed(0), antithetic=True,
                stratified=True, device=dev, graph=graph)
            live[graph] = tr
            return tr.advance

        summary[f"mc_{name}"]["profile"] = _idle(f"MC {name}", mc_step)
        if not all(torch.equal(u, v) for u, v in zip(
                live[True].vb, live[False].vb)) or not torch.equal(
                live[True].flat, live[False].flat):
            raise AssertionError(f"24b MC {name}: the profiled runs' last "
                                 "batches or params differ")
        print(f"  the profiled runs' last batches and params equal bit for "
              f"bit ({3 + CAPTURE_PROFILE_STEPS} steps)")

    phase(f"24c the flagship polish's Adam warmup captured against "
          f"graph=False (n_r {N_R}, {N_XI} x {N_ETA} dual grid, float64, "
          f"{CAPTURE_ADAM_STEPS} steps) ({card})")
    cfg = config.Config(model=config.ModelConfig(arch="separable"),
                        dtype="float64")
    init = ansatz.init_params(cfg.model, seed=cfg.train.seed,
                              dtype="float64", device=dev)
    logs = {}

    def warmup(g, cb):
        logs[g] = []

        def log(i, m):
            cb(i)
            logs[g].append((i, m["E_adam"]))

        torch.cuda.synchronize()
        t0 = time.time()
        p = variational.polish_spheroidal(
            init, cfg, n_r=N_R, n_xi=N_XI, n_eta=N_ETA, steps=0,
            adam_steps=CAPTURE_ADAM_STEPS, log_cb=log, device=dev, graph=g)
        torch.cuda.synchronize()
        return types.SimpleNamespace(params=ansatz.to_numpy_params(p),
                                     runtime_s=time.time() - t0)

    runs, marks = run_both("Adam warmup", warmup, CAPTURE_ADAM_STEPS, {
        "separable_fwd": CAPTURE_ADAM_STEPS,
        "separable_bwd": CAPTURE_ADAM_STEPS})
    _same_arrays("Adam warmup params", runs[True].params,
                 runs[False].params)
    if logs[True] != logs[False]:
        raise AssertionError(f"24c: the logged losses differ: {logs}")
    print(f"  the logged losses equal: {logs[True]} (E_adam "
          f"{logs[True][-1][1].hex()})")
    summary["adam_warmup"] = {
        ("captured" if g else "eager"): {
            "steps_per_s": CAPTURE_ADAM_STEPS / r.runtime_s}
        for g, r in runs.items()}
    summary["adam_warmup"]["loss_hex"] = logs[True][-1][1].hex()
    vb = variational.dual_grid_vbatch(cfg, N_R, N_XI, N_ETA, device=dev)

    def warm_step(graph):
        return variational.AdamWarmup(init, cfg, vb, CAPTURE_ADAM_STEPS,
                                      1.0, graph=graph).advance

    summary["adam_warmup"]["profile"] = _idle("Adam warmup", warm_step)
    print("captured: " + json.dumps(summary), flush=True)
    return summary


def main() -> int:
    import torch
    argv = sys.argv[1:]
    k1_root = step_root = None
    if argv == ["--k1-factors"]:
        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available; nothing to run",
                  file=sys.stderr)
            return 1
        sys.path.insert(0, HERE)
        from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
            _build
        t0 = time.time()
        _build.build(["separable_fwd", "separable_bwd"])
        print(f"K1 built in {time.time() - t0:.1f} s", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        k1_factor_phase(torch.device("cuda"), card_line())
        phase()
        return 0
    if argv == ["--rheads"]:
        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available; nothing to run",
                  file=sys.stderr)
            return 1
        sys.path.insert(0, HERE)
        from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
            _build
        t0 = time.time()
        _build.build(["train_fwd", "train_bwd"])
        print(f"K2 built in {time.time() - t0:.1f} s", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rheads_phase(torch.device("cuda"), card_line())
        phase()
        return 0
    if argv == ["--tracing"]:
        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available; nothing to run",
                  file=sys.stderr)
            return 1
        sys.path.insert(0, HERE)
        tracing_costs(card_line())
        return 0
    if argv[:1] == ["--k1-times"] and len(argv) <= 2:
        k1_root = os.path.abspath(argv[1] if len(argv) == 2 else HERE)
    elif argv[:1] == ["--step-times"] and len(argv) <= 2:
        step_root = os.path.abspath(argv[1] if len(argv) == 2 else HERE)
    elif argv and (len(argv) != 2 or argv[0] != "--mesh"
                   or not argv[1].isdigit() or int(argv[1]) < 2):
        print("usage: chip_smoke.py [--mesh N | --k1-times [ROOT] | "
              "--step-times [ROOT] | --tracing | --k1-factors | --rheads]  "
              "(N >= 2 cards)",
              file=sys.stderr)
        return 2
    multi = (int(argv[1]) if argv and k1_root is None and step_root is None
             else 0)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 1
    if k1_root is not None:
        sys.path.insert(0, k1_root)
        k1_times(k1_root, card_line())
        return 0
    if step_root is not None:
        sys.path.insert(0, step_root)
        step_times(step_root, card_line())
        return 0
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
        _build, _cuda
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
        pallas_residual as k3
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
    mpl = importlib.util.find_spec("matplotlib")
    print("matplotlib: " + (f"present ({mpl.origin})" if mpl else
                            "absent (phase 20 checks the figures' data "
                            "and draws nothing)"), flush=True)

    phase("2 build")
    t0 = time.time()
    _build.build()
    print(f"built {', '.join(_build.SOURCES)} in {time.time() - t0:.1f} s",
          flush=True)
    for name in _build.KERNELS:
        for line in ptxas_summary(name,
                                  _build.log_path(name).read_text()):
            print(f"  {name} {line}")
    # the bench line's ceiling chains (csrc/ceiling.cu), no TPU kernel's
    for line in _build.log_path("ceiling").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or \
                "spill" in line:
            print(f"  ceiling {line.strip()}")
    # K3: no instantiation at H <= 16 may spill (float64, float32 and
    # bfloat16 at every width)
    k3_ptxas = ptxas_entries("residual_fwd",
                             _build.log_path("residual_fwd").read_text())
    if len(k3_ptxas) != 3 * len(k3.SUPPORTED_HIDDEN):
        raise AssertionError(f"residual_fwd: {len(k3_ptxas)} instantiations "
                             "in the ptxas log")
    spilled = [e for e in k3_ptxas if e["h"] <= 16
               and e["spill_stores"] + e["spill_loads"] > 0]
    if spilled:
        raise AssertionError(f"K3 spills at H <= 16: {spilled}")
    # K1's float32 and bfloat16 builds (one thread a point): no training
    # instantiation at H <= 16 may spill, the factor ones included (the
    # point-gradient ones and H = 32 are printed above)
    k1_spilled = [
        (name, e) for name in ("separable_fwd", "separable_bwd")
        for e in ptxas_entries(name, _build.log_path(name).read_text())
        if e["dtype"] != "float64" and e["h"] <= 16 and not e["pg"]
        and e["spill_stores"] + e["spill_loads"] > 0]
    if k1_spilled:
        raise AssertionError(f"K1 float32/bfloat16 spills at H <= 16: "
                             f"{k1_spilled}")
    for name, pg in (("separable_fwd", False), ("separable_bwd", False),
                     ("separable_bwd", True), ("train_fwd", False),
                     ("train_bwd", False), ("train_bwd", True)):
        for dt in (torch.float64, torch.float32, torch.bfloat16):
            threads = _cuda.threads(dt)
            for h in _cuda.SUPPORTED_HIDDEN:
                blocks, smem = _cuda.occupancy(name, h, dt, pg)
                print(f"  {name}{' PG' if pg else ''} {str(dt)[6:]} H={h}: "
                      f"{smem} B shared memory a block of {threads} "
                      f"threads, {blocks} resident blocks per SM "
                      f"({blocks * threads // 32} warps)")
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        for h in _cuda.SUPPORTED_HIDDEN:
            for hg in K3_GATE_WIDTHS:
                blocks, smem = _cuda.occupancy("residual_fwd", h, dt,
                                               hidden_gate=hg)
                print(f"  residual_fwd {str(dt)[6:]} H={h} Hg={hg}: {smem} B "
                      f"shared memory a block of {_cuda.threads(dt)} "
                      f"threads, {blocks} resident blocks per SM "
                      f"({blocks * _cuda.threads(dt) // 32} warps)")
    sys.stdout.flush()

    if multi:
        multi_device_phase(multi, card)
        phase()
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

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
    # at that quotient, in both types too (float32's one-thread-a-point
    # kernels are instantiated per width)
    cases = [("flagship", vb, None, both), ("evaluate", vb_eval, None, both)]
    cases += [(f"H={h}", vb_eval, h, both)
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
            tol_psi, tol_lap, tol_bwd = k1_f32_bounds(psi_p, lap_p)
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
        worst = max((check_normwise(f"K1-bwd {nm} {label}", g, r_,
                                    tol_bwd)
                     for nm, g, r_ in zip(K1_GRADS, got, ref)),
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
    # a step evaluates the loss and its gradient in its line search (the
    # first step at its start too): one K1-bwd launch an evaluation
    print(f"line-search evaluations per L-BFGS step: "
          f"{lb['separable_bwd']:.2f} (budget "
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

    try:
        k2 = k2_phases(dev, card)
        k3_entry = k3_phases(dev, card)
        pg = pg_phase(dev, card)
        excited_phase(dev, card)
        mc_times = family_phase(dev, card)
        analysis_phase(dev, card)
        mesh_sweep_phase(dev, card)
        entry_points_phase(dev, card)
        bf16 = bf16_phase(dev, card)
        captured_phase(dev, card)
        k1_factor_phase(dev, card)
        rheads_phase(dev, card)
    finally:
        shutil.rmtree(KEEP_DIR, ignore_errors=True)
    phase()

    t64, t32, tmc = times["float64"], times["float32"], mc_times["separable"]
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
            # the float32 build at the flagship batch (phase 6) and on its
            # own main path, the MC trainer's 1 048 576 points (19c: one
            # launch a step)
            "float32": {"max_abs_err": errs["float32"][which],
                        "ms": t32[which], "plain_ms": t32[f"{which}_plain"],
                        "bound_ms": t32[f"{which}_bound"],
                        "bound_by": t32[f"{which}_bound_by"]},
            "float32_mc": {"launches": MC_STEPS,
                           "max_abs_err": tmc[f"{which}_err"],
                           "ms": tmc[which],
                           "plain_ms": tmc[f"{which}_plain"],
                           "bound_ms": tmc[f"{which}_bound"],
                           "bound_by": tmc[f"{which}_bound_by"]},
        })
    kernels += k2 + [k3_entry] + pg + bf16
    print(f"smoke run {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
