"""Fused (psi, lap psi) training kernel of the symmetric ansatz family (K2).

The PyTorch/CUDA counterpart of the JAX package's ``ops/pallas_train.py``
(``make_fused_psi_lap``: ``fwd_kernel`` and ``bwd_kernel``, called through
``psi_lap_train``). Per point it computes psi and lap psi of

    psi = g (b+ + P b- + ob) + e^{-a r1 - b r2} + P e^{-a r2 - b r1}

where b+- are the two weight-shared sigmoid-MLP branches 2 -> H -> H -> 1 on
the envelopes e^{-a r1}, e^{-a r2} (b- at the geometry mirrored at
x -> -x), g = gate(R), and (a, b) the exponents (b = 0 is LCAO). ob is the
output bias in the gerade sector and 0 in the ungerade one.

Three implementations of one arithmetic live here:
- ``psi_lap_train_plain``: the forward in vectorised tensor ops;
- ``psi_lap_train_vjp_plain``: its hand-written adjoint (weights, a, b, g,
  and with ``point_grads`` the points x, y, z, r), the adjoint the CUDA
  backward kernels compute;
- ``csrc/train_fwd.cu`` and ``csrc/train_bwd.cu``: the Hopper kernels
  (CUDA C++ for sm_90a, built by ``ops/_build.py``; ``csrc/train.cuh``,
  and ``csrc/train_tile.cuh`` for the float64 tiles on the tensor cores).

``TrainKernel`` (a ``torch.autograd.Function``) dispatches on the device of
its inputs: CUDA tensors launch the kernels (or the call raises), CPU
tensors take the plain versions. There is no fallback between the two.

The formulation. A branch's spatial gradients all lie in span{u1, u2}, the
unit vectors from its two nuclei (the gradient of e^{-a r} is -a e^{-a r}
u), so each hidden unit carries the 4-stack (value, coefficient on u1,
coefficient on u2, laplacian), and |grad|^2 = c1^2 + c2^2 + 2 c1 c2 c12 with
c12 = u1.u2 of that branch's geometry.
"""

from __future__ import annotations

import torch

from ..models import ansatz
from . import _cuda
from .pallas_separable import geometry_vjp

# launch counts of the CUDA kernels, K2-bwd's point-gradient instantiation
# apart (plain integers: a run can show that its path went through the
# kernels). Only the CUDA wrappers add to them.
launches = {"train_fwd": 0, "train_bwd": 0, "train_bwd_pg": 0}

SUPPORTED_HIDDEN = _cuda.SUPPORTED_HIDDEN


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def weight_shapes(hidden: int):
    """Shapes of the 6 kernel weights: h1.w, h1.b, h2.w, h2.b, out.w,
    out.b (biases as rows)."""
    return ((2, hidden), (1, hidden), (hidden, hidden), (1, hidden),
            (hidden, 1), (1, 1))


# ---------------------------------------------------------------------------
# Plain forward (vectorised; the CPU path and the kernel's yardstick)


def _envelopes(x, y, z, r, a, ry, rz, mirror):
    """Geometry and envelope stacks of one branch (csrc/train.cuh Env):
    r1, r2, 1/r1, 1/r2, c12 = u1.u2, and per envelope f = e^{-a r}, its
    gradient coefficient -a f and its laplacian f (a^2 - 2a/r)."""
    xs = -x if mirror else x
    d1x, d1y, d1z = xs - r, y - ry, z - rz
    d2x, d2y, d2z = xs + r, y + ry, z + rz
    r1 = torch.sqrt(d1x * d1x + d1y * d1y + d1z * d1z)
    r2 = torch.sqrt(d2x * d2x + d2y * d2y + d2z * d2z)
    i1, i2 = 1.0 / r1, 1.0 / r2
    c12 = (d1x * d2x + d1y * d2y + d1z * d2z) * i1 * i2
    f1 = torch.exp(-a * r1)
    f2 = torch.exp(-a * r2)
    return dict(r1=r1, r2=r2, i1=i1, i2=i2, c12=c12,
                f1=f1, g1=-a * f1, l1=f1 * (a * a - 2.0 * a * i1),
                f2=f2, g2=-a * f2, l2=f2 * (a * a - 2.0 * a * i2))


def _col(t):
    return t[:, None]


def _unit1(w1, b1, e):
    """First-layer units, (n, H): sigmoid and derivatives, gradient
    coefficients, laplacian and squared gradient norm of z."""
    w0, w1r = w1[0], w1[1]
    z = _col(e["f1"]) * w0 + _col(e["f2"]) * w1r + b1[0]
    ga = _col(e["g1"]) * w0
    gb = _col(e["g2"]) * w1r
    lz = _col(e["l1"]) * w0 + _col(e["l2"]) * w1r
    s = torch.sigmoid(z)
    d1 = s * (1.0 - s)
    d2 = d1 * (1.0 - 2.0 * s)
    c12 = _col(e["c12"])
    q = ga * ga + gb * gb + 2.0 * c12 * ga * gb
    return dict(s=s, d1=d1, d2=d2, ga=ga, gb=gb, lz=lz, q=q)


def _branch_fwd(weights, e):
    """Forward of one branch: its output (value, laplacian) and what the
    adjoint needs (the first-layer stacks and the second-layer units)."""
    w1, b1, w2, b2, ow, _ = weights
    u1 = _unit1(w1, b1, e)
    acts = (u1["s"], u1["d1"] * u1["ga"], u1["d1"] * u1["gb"],
            u1["d1"] * u1["lz"] + u1["d2"] * u1["q"])
    p0 = acts[0] @ w2 + b2[0]
    p1, p2, p3 = (t @ w2 for t in acts[1:])
    s = torch.sigmoid(p0)
    e1 = s * (1.0 - s)
    e2 = e1 * (1.0 - 2.0 * s)
    c12 = _col(e["c12"])
    qq = p1 * p1 + p2 * p2 + 2.0 * c12 * p1 * p2
    bl = e1 * p3 + e2 * qq
    owv = ow[:, 0]
    u2 = dict(p0=p0, p1=p1, p2=p2, p3=p3, s=s, e1=e1, e2=e2, qq=qq, bv=s,
              bl=bl)
    return s @ owv, bl @ owv, acts, u2


def _gz(a, b, e):
    """Guillemin-Zener pair: v1 = e^{-a r1 - b r2} with laplacian v1 s1,
    v2 = e^{-a r2 - b r1} with laplacian v2 s2."""
    base = a * a + b * b + 2.0 * a * b * e["c12"]
    v1 = torch.exp(-a * e["r1"] - b * e["r2"])
    s1 = base - 2.0 * a * e["i1"] - 2.0 * b * e["i2"]
    v2 = torch.exp(-a * e["r2"] - b * e["r1"])
    s2 = base - 2.0 * a * e["i2"] - 2.0 * b * e["i1"]
    return v1, s1, v2, s2


def psi_lap_train_plain(weights, a, b, g, x, y, z, r, *, p_sym: int = 1,
                        ry: float = 0.0, rz: float = 0.0):
    """(psi, lap psi) per point, plain tensor ops. weights: the 6 tensors in
    ``weight_shapes`` order (ob = 0 in the ungerade sector); a, b, g, x, y,
    z, r: (n,)."""
    p = float(p_sym)
    ep = _envelopes(x, y, z, r, a, ry, rz, False)
    em = _envelopes(x, y, z, r, a, ry, rz, True)
    vp, lp, _, _ = _branch_fwd(weights, ep)
    vm, lm, _, _ = _branch_fwd(weights, em)
    nnv = vp + p * vm + weights[5][0, 0]
    nnl = lp + p * lm
    v1, s1, v2, s2 = _gz(a, b, ep)
    return nnv * g + v1 + p * v2, nnl * g + v1 * s1 + p * (v2 * s2)


# ---------------------------------------------------------------------------
# Plain explicit adjoint (the CUDA backward kernels compute the same
# adjoint, with the sums over points and units in their own order)


def _branch_vjp(weights, e, a, cv, cl):
    """Forward and adjoint of one branch for output cotangents (cv, cl),
    (n,) each (csrc/train.cuh branch_stage). Returns the branch output
    (ov, ol), its weight gradients (dw1, db1, dw2, db2, dow), its
    cotangent of a, and the cotangents (df1, dg1, dl1, df2, dg2, dl2, dc12)
    of its envelope stacks and of c12 (which both layers' squared gradient
    norms read)."""
    w1, b1, w2, b2, ow, _ = weights
    ov, ol, acts, u2 = _branch_fwd(weights, e)
    owv = ow[:, 0]
    c12 = _col(e["c12"])
    dow = (_col(cv) * u2["bv"] + _col(cl) * u2["bl"]).sum(0)[:, None]
    # bv = s(p0), bl = e1(p0) p3 + e2(p0) qq, qq = p1^2 + p2^2 + 2 c12 p1 p2
    dbv = _col(cv) * owv
    dbl = _col(cl) * owv
    e3 = u2["e2"] * (1.0 - 2.0 * u2["s"]) - 2.0 * u2["e1"] * u2["e1"]
    dq = dbl * u2["e2"]
    dp = (dbv * u2["e1"] + dbl * (u2["e2"] * u2["p3"] + e3 * u2["qq"]),
          dq * (2.0 * u2["p1"] + 2.0 * c12 * u2["p2"]),
          dq * (2.0 * u2["p2"] + 2.0 * c12 * u2["p1"]),
          dbl * u2["e1"])
    dw2 = sum(act.T @ d for act, d in zip(acts, dp))
    db2 = dp[0].sum(0)[None, :]
    da0, da1, da2, da3 = (d @ w2.T for d in dp)
    dc12 = (dq * 2.0 * u2["p1"] * u2["p2"]).sum(1)
    # first layer: a0 = s, a1 = d1 ga, a2 = d1 gb, a3 = d1 lz + d2 q
    u = _unit1(w1, b1, e)
    d3 = u["d2"] * (1.0 - 2.0 * u["s"]) - 2.0 * u["d1"] * u["d1"]
    dz = (da0 * u["d1"] + (da1 * u["ga"] + da2 * u["gb"] + da3 * u["lz"])
          * u["d2"] + da3 * u["q"] * d3)
    dga = da1 * u["d1"] + da3 * u["d2"] * (2.0 * u["ga"]
                                           + 2.0 * c12 * u["gb"])
    dgb = da2 * u["d1"] + da3 * u["d2"] * (2.0 * u["gb"]
                                           + 2.0 * c12 * u["ga"])
    dlz = da3 * u["d1"]
    dc12 = dc12 + (da3 * u["d2"] * 2.0 * u["ga"] * u["gb"]).sum(1)
    dw1 = torch.stack([
        (dz * _col(e["f1"]) + dga * _col(e["g1"]) + dlz * _col(e["l1"])).sum(0),
        (dz * _col(e["f2"]) + dgb * _col(e["g2"]) + dlz * _col(e["l2"])).sum(0)])
    db1 = dz.sum(0)[None, :]
    w0, w1r = w1[0], w1[1]
    df1, dg1, dl1 = dz @ w0, dga @ w0, dlz @ w0
    df2, dg2, dl2 = dz @ w1r, dgb @ w1r, dlz @ w1r
    # f = e^{-a r}: df/da = -r f; g = -a f: dg/da = a r f - f;
    # l = f (a^2 - 2a/r): dl/da = f (2a - 2/r) - r l
    da = (df1 * (-e["r1"] * e["f1"]) + dg1 * (a * e["r1"] * e["f1"] - e["f1"])
          + dl1 * (e["f1"] * (2.0 * a - 2.0 * e["i1"]) - e["r1"] * e["l1"])
          + df2 * (-e["r2"] * e["f2"]) + dg2 * (a * e["r2"] * e["f2"] - e["f2"])
          + dl2 * (e["f2"] * (2.0 * a - 2.0 * e["i2"]) - e["r2"] * e["l2"]))
    return (ov, ol), (dw1, db1, dw2, db2, dow), da, \
        (df1, dg1, dl1, df2, dg2, dl2, dc12)


def _envelope_vjp(a, e, cot):
    """Cotangents (r1, r2, c12) of one branch from those of its envelope
    stacks and of c12 (``_branch_vjp``; csrc/train.cuh env_adjoint): per
    nucleus f = e^{-a r}: df/dr = -a f; g = -a f: dg/dr = a^2 f;
    l = f (a^2 - 2a/r): dl/dr = -a l + 2a f / r^2."""
    df1, dg1, dl1, df2, dg2, dl2, dc12 = cot

    def radial(f, l, i, df, dg, dl):
        return -a * f * df + a * a * f * dg + (2.0 * a * f * i * i - a * l) * dl

    return (radial(e["f1"], e["l1"], e["i1"], df1, dg1, dl1),
            radial(e["f2"], e["l2"], e["i2"], df2, dg2, dl2), dc12)


def psi_lap_train_vjp_plain(weights, a, b, g, x, y, z, r, dpsi, dlap, *,
                            p_sym: int = 1, ry: float = 0.0,
                            rz: float = 0.0, point_grads: bool = False):
    """Cotangents (6 weight grads, da, db, dg) of psi_lap_train_plain for
    output cotangents (dpsi, dlap). With ``point_grads`` also those of the
    points, (..., dx, dy, dz, dr): each branch's envelope cotangents and the
    GZ pair's carried through the geometry (the mirrored branch at
    xs = -x), as the kernels do. Otherwise the points are constants (the
    training path stops their gradients)."""
    p = float(p_sym)
    cv, cl = dpsi * g, dlap * g
    nnv, nnl = weights[5][0, 0], 0.0
    da = 0.0
    dws = None
    branches = []
    for mirror, pb in ((False, 1.0), (True, p)):
        e = _envelopes(x, y, z, r, a, ry, rz, mirror)
        (ov, ol), grads, da_m, cot = _branch_vjp(weights, e, a, pb * cv,
                                                 pb * cl)
        branches.append((mirror, e, cot))
        da = da + da_m
        nnv = nnv + pb * ov
        nnl = nnl + pb * ol
        dws = grads if dws is None else tuple(u + v for u, v in
                                              zip(dws, grads))
    ep = _envelopes(x, y, z, r, a, ry, rz, False)
    v1, s1, v2, s2 = _gz(a, b, ep)
    dv1 = dpsi + dlap * s1
    ds1 = dlap * v1
    dv2 = p * (dpsi + dlap * s2)
    ds2 = p * dlap * v2
    sa = 2.0 * a + 2.0 * b * ep["c12"]
    sb = 2.0 * b + 2.0 * a * ep["c12"]
    da = (da - ep["r1"] * v1 * dv1 + ds1 * (sa - 2.0 * ep["i1"])
          - ep["r2"] * v2 * dv2 + ds2 * (sa - 2.0 * ep["i2"]))
    db = (-ep["r2"] * v1 * dv1 + ds1 * (sb - 2.0 * ep["i2"])
          - ep["r1"] * v2 * dv2 + ds2 * (sb - 2.0 * ep["i1"]))
    dg = dpsi * nnv + dlap * nnl
    dob = cv.sum().reshape(1, 1)
    grads = (tuple(dws) + (dob,), da, db, dg)
    if not point_grads:
        return grads

    # the GZ pair on the direct geometry: v1 = e^{-a r1 - b r2}, v2 its
    # swap, s1 = base - 2a/r1 - 2b/r2, s2 the swap, base with 2ab c12
    di1 = -2.0 * (a * ds1 + b * ds2)
    di2 = -2.0 * (b * ds1 + a * ds2)
    gz_r1 = (-a * v1 * dv1 - b * v2 * dv2 - di1 * ep["i1"] * ep["i1"])
    gz_r2 = (-b * v1 * dv1 - a * v2 * dv2 - di2 * ep["i2"] * ep["i2"])
    gz_c12 = 2.0 * a * b * (ds1 + ds2)
    dx = dy = dz = dr = 0.0
    for mirror, e, cot in branches:
        dr1, dr2, dc12 = _envelope_vjp(a, e, cot)
        if not mirror:
            dr1, dr2, dc12 = dr1 + gz_r1, dr2 + gz_r2, dc12 + gz_c12
        gx, gy, gz_, gr = geometry_vjp(-x if mirror else x, y, z, r, ry, rz,
                                       e["i1"], e["i2"], e["c12"], dr1, dr2,
                                       dc12)
        dx = dx - gx if mirror else dx + gx
        dy, dz, dr = dy + gy, dz + gz_, dr + gr
    return grads + (dx, dy, dz, dr)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/train_fwd.cu, csrc/train_bwd.cu)


# The kernels' work layout. Float64 (csrc/train_tile.cuh): blocks of 256
# threads walk tiles of 32 points (16 at H = 32). Float32: one thread a
# point, 128 points a block. K2-fwd takes one block a tile; K2-bwd's grid
# is capped at the resident blocks per SM its __launch_bounds__ asks for
# times the H100's 132 SMs, so one wave.
GRID_BLOCKS_PER_SM = {torch.float64: 2, torch.float32: 3}
N_SM = 132


def points_per_tile(hidden: int, dtype=torch.float64) -> int:
    """Points a block evaluates at a time."""
    if dtype == torch.float64:
        return 16 if hidden > 16 else 32
    return 128


def n_tiles(n: int, hidden: int, dtype=torch.float64) -> int:
    """Tiles of n points; the last one is padded."""
    return -(-n // points_per_tile(hidden, dtype))


def grid_blocks(n: int, hidden: int, dtype=torch.float64) -> int:
    """Blocks of a K2-bwd launch: one a tile, at most GRID_BLOCKS_PER_SM *
    N_SM; each block walks the tiles blockIdx, blockIdx + grid, ... in
    order. The count depends on n, H and the dtype alone, so the rows of
    partial weight gradients (one a block), their order, and so the bits do
    too."""
    return max(1, min(n_tiles(n, hidden, dtype),
                      GRID_BLOCKS_PER_SM[dtype] * N_SM))


def _lib(name: str):
    """The typed library of K2-fwd or K2-bwd (its extra ints: the grid and
    the point-gradient flag), its tiles checked against points_per_tile
    once."""
    fwd = name == "train_fwd"
    return _cuda.tiled_lib(name, 10 if fwd else 18, "train", points_per_tile,
                           n_extra_int=0 if fwd else 2)


def occupancy(name: str, hidden: int, dtype,
              point_grads: bool = False) -> tuple[int, int]:
    """(resident blocks per SM, shared memory bytes per block) of kernel
    ``name`` ("train_fwd" or "train_bwd", and of the latter's
    point-gradient instantiation) at this width and dtype on the current
    card."""
    return _cuda.occupancy(_lib(name), hidden, dtype, point_grads)


def threads(dtype) -> int:
    """Threads a block of either kernel."""
    return 256 if dtype == torch.float64 else 128


def train_fwd_cuda(weights, a, b, g, x, y, z, r, *, p_sym: int = 1,
                   ry: float = 0.0, rz: float = 0.0):
    """K2 forward on the card: (psi, lap) for CUDA tensors."""
    hidden = weights[0].shape[1]
    pts = (x, y, z, r, a, b, g)
    _cuda.check_inputs(hidden, weights, weight_shapes(hidden), pts)
    pts = [t.contiguous() for t in pts]
    n = pts[0].shape[0]
    psi = torch.empty_like(pts[0])
    lap = torch.empty_like(pts[0])
    lib = _lib("train_fwd")
    _cuda.launch(lib, pts[0].dtype, pts[0].device,
                 (*pts, _cuda.pack(weights), psi, lap), n, hidden, p_sym,
                 ry, rz)
    launches["train_fwd"] += 1
    return psi, lap


def train_bwd_cuda(weights, a, b, g, x, y, z, r, dpsi, dlap, *,
                   p_sym: int = 1, ry: float = 0.0, rz: float = 0.0,
                   point_grads: bool = False):
    """K2 backward on the card: (6 weight grads, da, db, dg), and with
    ``point_grads`` also (dx, dy, dz, dr) from the kernels' point-gradient
    instantiations. Each block writes one row of partial weight gradients,
    summed in a fixed order (no atomics); the rows are summed here —
    repeatable bit for bit."""
    hidden = weights[0].shape[1]
    pts = (x, y, z, r, a, b, g)
    shapes = weight_shapes(hidden)
    _cuda.check_inputs(hidden, weights, shapes, pts + (dpsi, dlap))
    pts = [t.contiguous() for t in pts]
    dpsi, dlap = dpsi.contiguous(), dlap.contiguous()
    n = pts[0].shape[0]
    dtype = pts[0].dtype
    lib = _lib("train_bwd")
    grid = grid_blocks(n, hidden, dtype)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    partials = torch.empty((grid, sum(sizes)), dtype=dtype,
                           device=pts[0].device)
    da, db, dg = (torch.empty_like(pts[0]) for _ in range(3))
    dpts = tuple(torch.empty_like(pts[0]) if point_grads else None
                 for _ in range(4))
    _cuda.launch(lib, dtype, pts[0].device,
                 (*pts, _cuda.pack(weights), dpsi, dlap, da, db, dg,
                  partials, *dpts), n, hidden, p_sym, ry, rz,
                 extra_ints=(grid, int(point_grads)))
    launches["train_bwd_pg" if point_grads else "train_bwd"] += 1
    dws = tuple(t.reshape(s) for t, s in
                zip(torch.split(partials.sum(0), sizes), shapes))
    return (dws, da, db, dg) + (dpts if point_grads else ())


# ---------------------------------------------------------------------------
# autograd.Function and the training entry point


class TrainKernel(torch.autograd.Function):
    """(psi, lap) = K2(a, b, g, x, y, z, r; weights) with its hand-written
    backward. cfg = (p_sym, ry, rz, point_grads). Gradients flow to the 6
    weights and to a, b, g; to the points x, y, z, r only with point_grads
    (otherwise they are constants)."""

    @staticmethod
    def forward(ctx, cfg, a, b, g, x, y, z, r, *weights):
        p_sym, ry, rz, _ = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(a, b, g, x, y, z, r, *weights)
        kw = dict(p_sym=p_sym, ry=ry, rz=rz)
        if a.is_cuda:
            return train_fwd_cuda(weights, a, b, g, x, y, z, r, **kw)
        return psi_lap_train_plain(weights, a, b, g, x, y, z, r, **kw)

    @staticmethod
    def backward(ctx, dpsi, dlap):
        a, b, g, x, y, z, r, *weights = ctx.saved_tensors
        p_sym, ry, rz, point_grads = ctx.cfg
        kw = dict(p_sym=p_sym, ry=ry, rz=rz, point_grads=point_grads)
        vjp = train_bwd_cuda if a.is_cuda else psi_lap_train_vjp_plain
        dws, da, db, dg, *dpts = vjp(weights, a, b, g, x, y, z, r, dpsi,
                                     dlap, **kw)
        return (None, da, db, dg, *(dpts or (None,) * 4)) + tuple(dws)


def kernel_weights(params: dict, mcfg, dtype) -> tuple:
    """The 6 kernel weights from a params tree, cast to the point dtype,
    biases as rows. The output bias is a constant 0 in the ungerade
    sector (exact antisymmetry), so ``params["out"]["b"]`` gets no
    gradient there."""
    h1, h2, out = params["h1"], params["h2"], params["out"]
    if mcfg.inversion_symmetry > 0:
        ob = out["b"].reshape(1, 1).to(dtype)
    else:
        ob = torch.zeros((1, 1), dtype=dtype, device=out["b"].device)
    return (h1["w"].to(dtype), h1["b"].reshape(1, -1).to(dtype),
            h2["w"].to(dtype), h2["b"].reshape(1, -1).to(dtype),
            out["w"].to(dtype), ob)


def psi_lap_train(params: dict, mcfg, x, y, z, r,
                  point_grads: bool = False):
    """(psi, lap, E) of the symmetric family through the fused kernel. The
    R-only heads (E, gate, alpha, b) run and differentiate in torch
    autograd; the spatial network runs in the kernel through TrainKernel,
    so autograd of any loss composes exactly. By default the point
    coordinates are constants (training treats the batch as data); with
    ``point_grads`` gradients flow to x, y, z and r too (force-through-batch
    analyses), r's through the kernel and the heads.

    Covers fixed exponents, trainable alpha(R) and Guillemin-Zener b(R).
    Raises NotImplementedError for the minimal family and R-input
    models."""
    ansatz.check_supported(params, mcfg)
    if "lam1" in params:
        raise NotImplementedError(
            "separable params: their kernel is "
            "ops.pallas_separable.psi_lap_train_separable")
    dtype = x.dtype
    r_pts = r
    if not point_grads:
        x, y, z, r_pts = (t.detach() for t in (x, y, z, r))
    e = ansatz.energy(params, r)
    g = ansatz.gate(params, r)
    a = (ansatz.orbital_exponent(params, r) if "alpha1" in params
         else torch.ones_like(r))
    b = ansatz.gz_exponent(params, r, mcfg.inversion_symmetry, a)
    cfg = (int(mcfg.inversion_symmetry), float(mcfg.ry), float(mcfg.rz),
           bool(point_grads))
    psi, lap = TrainKernel.apply(cfg, a.to(dtype), b.to(dtype), g.to(dtype),
                                 x, y, z, r_pts,
                                 *kernel_weights(params, mcfg, dtype))
    return psi, lap, e
