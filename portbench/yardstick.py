"""The benchmark's frozen yardstick: operation counts, bounds and peaks.

Copies, frozen here so that no later change to the program moves them:

- the per-point operation counts of K1 (``csrc/separable_{fwd,bwd}.cu``)
  and K2 (``csrc/train_{fwd,bwd}.cu``) and the least time of a call,
  ``bound_ms`` (from ``chip_smoke.py``);
- the model FLOPs a point of one residual training step,
  ``separable_flops_per_point`` and ``analytic_flops_per_point`` (from the
  port's ``bench.py``), and from them the FLOPs of a quotient step, whose
  E(R) head is a function of R alone and is counted once a row
  (``step_flops``);
- the published peaks of one NVIDIA H100 SXM (dense, 700 W): 67 TFLOP/s in
  float32 outside the tensor cores, 67 TFLOP/s of float64 on the tensor
  cores and 34 TFLOP/s outside them, 989 TFLOP/s of bfloat16 on the tensor
  cores, 3.35 TB/s of HBM3. A card set below 700 W runs slower: the run
  prints its power limit beside every share.

A multiply-add counts as 2 operations and a transcendental as 1.
"""

from __future__ import annotations

PEAK_FP64_PRODUCTS, PEAK_FP64_OTHER, PEAK_FP32 = 67e12, 34e12, 67e12
PEAK_BF16_PRODUCTS = 989e12
PEAK_BYTES = 3.35e12
# the peak a whole step's model FLOPs are held to, by type: float32 on the
# FMA units, float64 on the tensor cores (an upper bound of both pipes)
PEAK_STEP = {"float32": PEAK_FP32, "float64": PEAK_FP64_PRODUCTS,
             "bfloat16": PEAK_BF16_PRODUCTS}
# the H^2 coefficient of each kernel's count: its H x H products
PRODUCT_H2 = {("K1", "fwd"): 12, ("K1", "bwd"): 36,
              ("K2", "fwd"): 16, ("K2", "bwd"): 48}


def k1_fwd_ops(h: int) -> int:
    """K1-fwd a point: two tanh MLPs of 6 H^2 + 29 H + 1, geometry, GZ and
    the bounded correction."""
    return 12 * h * h + 58 * h + 117


def k1_bwd_ops(h: int) -> int:
    """K1-bwd a point: the forward, the adjoint of the correction, product
    rule and GZ pair (117), per MLP its layers' adjoint (6 H^2 + 54 H) and
    weight-gradient sums (6 H^2 + 6 H + 1)."""
    return k1_fwd_ops(h) + 24 * h * h + 120 * h + 119


def k2_fwd_ops(h: int) -> int:
    """K2-fwd a point: per branch the envelope geometry (43), the first
    layer (29 H) and the second with its output (8 H^2 + 23 H), then the
    mirror, the combination and the GZ pair (43)."""
    return 16 * h * h + 104 * h + 129


def k2_bwd_ops(h: int) -> int:
    """K2-bwd a point: the forward, per branch the adjoints (8 H^2 + 90 H +
    30) and weight-gradient sums (8 H^2 + H), the output sums (4 H + 1) and
    the GZ adjoint (43)."""
    return k2_fwd_ops(h) + 32 * h * h + 186 * h + 104


OPS = {("K1", "fwd"): k1_fwd_ops, ("K1", "bwd"): k1_bwd_ops,
       ("K2", "fwd"): k2_fwd_ops, ("K2", "bwd"): k2_bwd_ops}


def bound_ms(n: int, h: int, dtype: str, which: str, kernel: str = "K1"):
    """(least time in ms, "bytes" or "operations") of one call at n points:
    each input read once and each output written once at the memory rate,
    against the operations at the peak rates of their type. In float64 and
    bfloat16 the H x H products run at the type's tensor-core rate and the
    rest outside the tensor cores, side by side (the longer share bounds
    the call); float32 counts every operation at its one rate."""
    size = {"float64": 8, "float32": 4, "bfloat16": 2}[dtype]
    if kernel == "K1":
        wsize = 2 * (h * h + 5 * h + 1)
        # x y z r a b -> psi lap; + dpsi dlap -> da db, dW
        nbytes = size * ((8 * n + wsize) if which == "fwd"
                         else (10 * n + 2 * wsize))
    else:
        wsize = h * h + 5 * h + 1
        # x y z r a b g -> psi lap; + dpsi dlap -> da db dg, dW
        nbytes = size * ((9 * n + wsize) if which == "fwd"
                         else (12 * n + 2 * wsize))
    ops = n * OPS[(kernel, which)](h)
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


def analytic_flops_per_point(h: int, he: int, hg: int) -> float:
    """Model FLOPs a point of one symmetric-family training step: the
    forward-Laplacian pass (4 envelopes, the 5-tuple through 2 -> H -> H
    -> 1 twice, the R heads, the assembly), backward ~ 2x forward, Adam."""
    env = 4 * 30
    layer1 = 2 * h * 46
    layer2 = 2 * h * (10 * h + 26)
    out = 2 * 10 * h
    gate = hg * 8
    ehead = he * 6 + 2 * he * he + 2 * he
    fwd = env + layer1 + layer2 + out + gate + ehead + 30
    return 3.0 * fwd + 18.0


def separable_flops_per_point(h: int, he: int, ha: int) -> float:
    """Model FLOPs a point of one separable training step: K1-fwd and
    K1-bwd's counts, the E, alpha(R) and b(R) heads and the assembly
    (forward ~ 1/3 of forward + backward), Adam. 23 821 at H 16, He 32,
    Ha 8."""
    ehead = he * 6 + 2 * he * he + 2 * he
    heads = 2 * ha * 8
    return k1_fwd_ops(h) + k1_bwd_ops(h) + 3.0 * (ehead + heads + 30) + 18.0


def ehead_flops(he: int) -> int:
    """The E(R) head's forward at one R, 1 -> He -> He -> 1, as the two
    functions above count it."""
    return he * 6 + 2 * he * he + 2 * he


def flops_per_point(model: dict) -> float:
    """The model FLOPs a point of one residual training step of a
    configuration's model (its ``model`` block): the E(R) head at every
    point, as the residual multiplies psi by E(R) there."""
    h, he = model["hidden"], model["hidden_e"]
    if model["arch"] == "separable":
        return separable_flops_per_point(h, he, model["hidden_alpha"])
    return analytic_flops_per_point(h, he, model["hidden_gate"])


def step_flops(model: dict, objective: str, points: int, rows: int) -> float:
    """The model FLOPs of one step over ``points`` quadrature or collocation
    points in ``rows`` R rows. ``objective`` is "residual" (the E(R) head at
    every point) or "quotient" (the Rayleigh quotient of each row, whose
    head term evaluates E(R) once a row: its forward and backward move from
    the points to the rows). Padding and any work the step does that its
    result does not need are not counted."""
    per_point = flops_per_point(model)
    if objective == "residual":
        return points * per_point
    if objective != "quotient":
        raise ValueError(f"no FLOP count for the objective {objective!r}")
    e = 3.0 * ehead_flops(model["hidden_e"])
    return points * (per_point - e) + rows * e
