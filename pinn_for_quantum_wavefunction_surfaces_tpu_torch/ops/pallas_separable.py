"""Fused (psi, lap psi) training kernel of the separable-spheroidal family.

The PyTorch/CUDA counterpart of the JAX package's ``ops/pallas_separable.py``
(``make_fused_psi_lap_separable``: ``fwd_kernel`` and ``bwd_kernel``, called
through ``psi_lap_train_separable``). Per point it computes psi and lap psi of

    psi = Phi_GZ * exp(3 tanh((lam(t) + mu(eta^2)) / 3))

with the two width-H tanh MLPs run on 1-D derivative triples [f, f', f''].

Three implementations of one arithmetic live here:
- ``psi_lap_separable_plain``: the forward in vectorised tensor ops;
- ``psi_lap_separable_vjp_plain``: its hand-written adjoint (weights, a, b,
  and with ``point_grads`` the points x, y, z, r), step for step as the
  CUDA backward kernel does it;
- ``csrc/separable_fwd.cu`` and ``csrc/separable_bwd.cu``: the Hopper
  kernels (CUDA C++ for sm_90a, built by ``ops/_build.py``).

``SeparableKernel`` (a ``torch.autograd.Function``) dispatches on the device
of its inputs: CUDA tensors launch the kernels (or the call raises), CPU
tensors take the plain versions. There is no fallback between the two.

The formulation. Every spatial gradient in the family lies in span{u1, u2}
(the unit vectors from the two nuclei), so a gradient is kept as its two
coefficients on (u1, u2) and every dot product reduces to scalars with
u1.u2 = c12. The gradients of t and eta^2 are orthogonal (u1+u2 is
orthogonal to u1-u2), so per point the whole forward Laplacian is a handful
of scalars besides the two MLPs. The kernels hold those scalars per point
in registers and the MLPs' [3 points, H] triples as tiles in shared
memory, whose H x H products run on the float64 tensor cores
(``csrc/separable.cuh``); ``points_per_tile`` and ``grid_blocks`` size the
launches.
"""

from __future__ import annotations


import torch

from ..models import ansatz
from ..models.ansatz import LOG_CORR_CAP
from . import _cuda

# launch counts of the CUDA kernels, K1-bwd's point-gradient instantiation
# apart (plain integers: a run can show that its path went through the
# kernels). Only the CUDA wrappers add to them.
launches = {"separable_fwd": 0, "separable_bwd": 0, "separable_bwd_pg": 0}

SUPPORTED_HIDDEN = _cuda.SUPPORTED_HIDDEN

_W_NAMES = (("lam1", "w"), ("lam1", "b"), ("lam2", "w"), ("lam2", "b"),
            ("lamout", "w"), ("lamout", "b"),
            ("mu1", "w"), ("mu1", "b"), ("mu2", "w"), ("mu2", "b"),
            ("muout", "w"), ("muout", "b"))


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def weight_shapes(hidden: int):
    """Shapes of the 12 kernel weights (one MLP's six, twice)."""
    return ((2, hidden), (1, hidden), (hidden, hidden), (1, hidden),
            (hidden, 1), (1, 1)) * 2


# ---------------------------------------------------------------------------
# Plain forward (vectorised; the CPU path and the kernel's yardstick)


def _geometry(x, y, z, r, ry, rz):
    """Radii, inverse radii and c12 = u1.u2 for nuclei at (+-r, +-ry, +-rz)."""
    d1x, d1y, d1z = x - r, y - ry, z - rz
    d2x, d2y, d2z = x + r, y + ry, z + rz
    r1 = torch.sqrt(d1x * d1x + d1y * d1y + d1z * d1z)
    r2 = torch.sqrt(d2x * d2x + d2y * d2y + d2z * d2z)
    i1, i2 = 1.0 / r1, 1.0 / r2
    c12 = (d1x * d2x + d1y * d2y + d1z * d2z) * i1 * i2
    return r1, r2, i1, i2, c12


def geometry_vjp(xs, y, z, r, ry, rz, i1, i2, c12, dr1, dr2, dc12):
    """Adjoint of the scalar geometry of one pair of nuclei (csrc/common.cuh
    geometry_adjoint): the cotangents (dxs, dy, dz, dr) of the point and the
    nuclear offset r from those of r1, r2 and c12 = u1.u2, for the
    displacements d1 = (xs - r, y - ry, z - rz), d2 = (xs + r, y + ry,
    z + rz): dr_i/dd_i = u_i, dc12/dd1 = (u2 - c12 u1)/r1 and the mirror
    image for d2. Shared by both families (the symmetric family's mirrored
    branch passes xs = -x)."""
    u1 = ((xs - r) * i1, (y - ry) * i1, (z - rz) * i1)
    u2 = ((xs + r) * i2, (y + ry) * i2, (z + rz) * i2)
    k1, k2 = dc12 * i1, dc12 * i2
    g1 = [dr1 * v1 + k1 * (v2 - c12 * v1) for v1, v2 in zip(u1, u2)]
    g2 = [dr2 * v2 + k2 * (v1 - c12 * v2) for v1, v2 in zip(u1, u2)]
    return g1[0] + g2[0], g1[1] + g2[1], g1[2] + g2[2], g2[0] - g1[0]


def _features(r, r1, r2, i1, i2, c12):
    """The MLP inputs t, eta^2 with the scalars of their spatial stacks.

    t = e^{r - (r1+r2)/2}: grad t = -t (u1+u2)/2, lap t = tl;
    eta = (r1-r2)/(2r): grad eta^2 = (ev/r)(u1-u2), lap eta^2 = el2.
    gtt = |grad t|^2, gee = |grad eta^2|^2 (grad t . grad eta^2 == 0)."""
    t0 = torch.exp(r - 0.5 * (r1 + r2))
    tl = t0 * (0.5 * (1.0 + c12) - (i1 + i2))
    gtt = 0.5 * t0 * t0 * (1.0 + c12)
    inv_r = 1.0 / r
    ev = (r1 - r2) * (0.5 * inv_r)
    e0 = ev * ev
    el2 = 2.0 * ev * (i1 - i2) * inv_r + (1.0 - c12) * inv_r * inv_r
    gee = 2.0 * e0 * (1.0 - c12) * inv_r * inv_r
    kt = -0.5 * t0 * (1.0 + c12)       # <g, grad t> = kt (g1 + g2)
    ke = ev * inv_r * (1.0 - c12)      # <g, grad eta^2> = ke (g1 - g2)
    return t0, tl, gtt, e0, el2, gee, kt, ke


def _gz(a, b, p, r1, r2, i1, i2, c12):
    """Phi_GZ = fA + P fB' as (value, grad coefficients on (u1, u2), lap)."""
    fa = torch.exp(-a * r1 - b * r2)
    fb = p * torch.exp(-a * r2 - b * r1)
    s = a * a + b * b + 2.0 * a * b * c12
    sa = s - 2.0 * a * i1 - 2.0 * b * i2
    sb = s - 2.0 * a * i2 - 2.0 * b * i1
    phi0 = fa + fb
    p1 = -(a * fa + b * fb)
    p2 = -(b * fa + a * fb)
    phil = fa * sa + fb * sb
    return fa, fb, sa, sb, phi0, p1, p2, phil


def _mlp_fwd(s, cf, w1, b1, w2, b2, ow, ob):
    """Width-H tanh MLP 2 -> H -> H -> 1 on the triple [f, df/ds, d2f/ds2]
    of a scalar input s (the other input cf is constant in space).
    Returns the output triple and the activations the adjoint needs."""
    w = w1[0]
    zz = s[:, None] * w + cf[:, None] * w1[1] + b1[0]
    tt = torch.tanh(zz)
    g = 1.0 - tt * tt
    h = -2.0 * tt * g
    a1 = (tt, g * w, h * w * w)
    lin = (a1[0] @ w2 + b2[0], a1[1] @ w2, a1[2] @ w2)
    u = torch.tanh(lin[0])
    gg = 1.0 - u * u
    hh = -2.0 * u * gg
    a2 = (u, gg * lin[1], gg * lin[2] + hh * lin[1] * lin[1])
    owv = ow[:, 0]
    out = (a2[0] @ owv + ob[0, 0], a2[1] @ owv, a2[2] @ owv)
    return out, (a1, lin, a2, tt, g, h, u, gg, hh)


def _top(l_tr, m_tr, phi0, phil, p1, p2, feats):
    """Bounded correction exp(3 tanh((lam+mu)/3)) and the product rule."""
    t0, tl, gtt, e0, el2, gee, kt, ke = feats
    c = LOG_CORR_CAP
    l0, l1, l2 = l_tr
    m0, m1, m2 = m_tr
    q0 = l0 + m0
    qq = l1 * l1 * gtt + m1 * m1 * gee            # |grad(lam+mu)|^2
    ql = l1 * tl + l2 * gtt + m1 * el2 + m2 * gee  # lap(lam+mu)
    th = torch.tanh(q0 / c)
    d1 = 1.0 - th * th
    d2 = -2.0 * th * d1
    bl = d1 * ql + d2 * qq / c                     # lap of c tanh(q/c)
    wv = bl + d1 * d1 * qq                         # lap(corr) / corr
    gpt = kt * (p1 + p2)                           # <grad phi, grad t>
    gpe = ke * (p1 - p2)                           # <grad phi, grad eta^2>
    xv = l1 * gpt + m1 * gpe                       # <grad phi, grad q>
    e = torch.exp(c * th)
    kk = phil + phi0 * wv + 2.0 * d1 * xv
    return phi0 * e, e * kk, (q0, qq, ql, th, d1, d2, bl, wv, gpt, gpe, xv,
                              e, kk)


def psi_lap_separable_plain(weights, a, b, x, y, z, r, *, p_sym: int = 1,
                            ry: float = 0.0, rz: float = 0.0):
    """(psi, lap psi) per point, plain tensor ops. weights: the 12 tensors
    in ``weight_shapes`` order; a, b, x, y, z, r: (n,)."""
    l_w, m_w = weights[:6], weights[6:]
    r1, r2, i1, i2, c12 = _geometry(x, y, z, r, ry, rz)
    feats = _features(r, r1, r2, i1, i2, c12)
    cf = 0.25 * r
    l_tr, _ = _mlp_fwd(feats[0], cf, *l_w)
    m_tr, _ = _mlp_fwd(feats[3], cf, *m_w)
    _, _, _, _, phi0, p1, p2, phil = _gz(a, b, float(p_sym), r1, r2, i1, i2,
                                         c12)
    psi, lap, _ = _top(l_tr, m_tr, phi0, phil, p1, p2, feats)
    return psi, lap


# ---------------------------------------------------------------------------
# Plain explicit adjoint (the CUDA backward kernel transliterates this)


def _mlp_vjp(s, cf, w1, w2, ow, act, dout):
    """Adjoint of _mlp_fwd w.r.t. its six weights, given the output
    triple's cotangent dout = (d0, d1, d2), each (n,). Also returns the
    cotangent dz0 (n, H) of the first layer's pre-activations, from which
    the inputs' cotangents are ds = dz0 w1[0] and dcf = dz0 w1[1] (the seed
    triple's other entries, 1 and 0, are constants)."""
    a1, lin, a2, tt, g, h, u, gg, hh = act
    owv = ow[:, 0]
    d0, dd1, dd2 = (c[:, None] for c in dout)
    dow = (a2[0] * d0 + a2[1] * dd1 + a2[2] * dd2).sum(0)[:, None]
    dob = dout[0].sum().reshape(1, 1)
    db0, db1, db2 = d0 * owv, dd1 * owv, dd2 * owv
    # a2 = (u, gg lin1, gg lin2 + hh lin1^2), gg = 1 - u^2, hh = -2 u gg
    dlin1 = db1 * gg + db2 * 2.0 * hh * lin[1]
    dlin2 = db2 * gg
    dgg = db1 * lin[1] + db2 * lin[2]
    dhh = db2 * lin[1] * lin[1]
    du = db0 - 2.0 * gg * dhh
    dgg = dgg - 2.0 * u * dhh
    du = du - 2.0 * u * dgg
    dlin0 = du * gg
    glin = (dlin0, dlin1, dlin2)
    dw2 = a1[0].T @ glin[0] + a1[1].T @ glin[1] + a1[2].T @ glin[2]
    db2_ = glin[0].sum(0)[None, :]
    da = [gc @ w2.T for gc in glin]
    # a1 = (tt, g w, h w^2) from the seed triple (z0, w, 0)
    w = w1[0]
    dz1 = da[1] * g + da[2] * 2.0 * h * w
    dg = da[1] * w
    dh = da[2] * w * w
    dt = da[0] - 2.0 * g * dh
    dg = dg - 2.0 * tt * dh
    dt = dt - 2.0 * tt * dg
    dz0 = dt * g
    dw1 = torch.stack([(s[:, None] * dz0 + dz1).sum(0),
                       (cf[:, None] * dz0).sum(0)])
    db1 = dz0.sum(0)[None, :]
    return (dw1, db1, dw2, db2_, dow, dob), dz0


def psi_lap_separable_vjp_plain(weights, a, b, x, y, z, r, dpsi, dlap, *,
                                p_sym: int = 1, ry: float = 0.0,
                                rz: float = 0.0, point_grads: bool = False):
    """Cotangents (12 weight grads, da, db) of psi_lap_separable_plain for
    output cotangents (dpsi, dlap). With ``point_grads`` also those of the
    points, (..., dx, dy, dz, dr): the adjoint carried past the MLPs
    through the features, the GZ pair and the geometry, as the kernel's
    point_adjoint (csrc/separable.cuh) does. Otherwise the points are
    constants (the training path stops their gradients)."""
    l_w, m_w = weights[:6], weights[6:]
    p = float(p_sym)
    c = LOG_CORR_CAP
    r1, r2, i1, i2, c12 = _geometry(x, y, z, r, ry, rz)
    feats = _features(r, r1, r2, i1, i2, c12)
    t0, tl, gtt, e0, el2, gee, kt, ke = feats
    cf = 0.25 * r
    l_tr, l_act = _mlp_fwd(t0, cf, *l_w)
    m_tr, m_act = _mlp_fwd(e0, cf, *m_w)
    fa, fb, sa, sb, phi0, p1, p2, phil = _gz(a, b, p, r1, r2, i1, i2, c12)
    _, _, st = _top(l_tr, m_tr, phi0, phil, p1, p2, feats)
    q0, qq, ql, th, d1, d2, bl, wv, gpt, gpe, xv, e, kk = st
    l1, m1 = l_tr[1], m_tr[1]

    # psi = phi0 e, lap = e kk, kk = phil + phi0 wv + 2 d1 xv
    de = dpsi * phi0 + dlap * kk
    dkk = dlap * e
    dphi0 = dpsi * e + dkk * wv
    dphil = dkk
    dwv = dkk * phi0
    dd1 = dkk * 2.0 * xv
    dxv = dkk * 2.0 * d1
    # wv = bl + d1^2 qq
    dbl = dwv
    dd1 = dd1 + dwv * 2.0 * d1 * qq
    dqq = dwv * d1 * d1
    # bl = d1 ql + d2 qq / c
    dd1 = dd1 + dbl * ql
    dql = dbl * d1
    dd2 = dbl * qq / c
    dqq = dqq + dbl * d2 / c
    # e = exp(c th), d2 = -2 th d1, d1 = 1 - th^2, th = tanh(q0 / c)
    dth = de * e * c
    dth = dth - 2.0 * d1 * dd2
    dd1 = dd1 - 2.0 * th * dd2
    dth = dth - 2.0 * th * dd1
    dq0 = dth * d1 / c
    # xv = l1 gpt + m1 gpe;  ql, qq as in _top
    dl1 = dxv * gpt + dql * tl + dqq * 2.0 * l1 * gtt
    dm1 = dxv * gpe + dql * el2 + dqq * 2.0 * m1 * gee
    dl2 = dql * gtt
    dm2 = dql * gee
    dgpt = dxv * l1
    dgpe = dxv * m1
    # gpt = kt (p1 + p2), gpe = ke (p1 - p2)
    dp1 = dgpt * kt + dgpe * ke
    dp2 = dgpt * kt - dgpe * ke
    # GZ: phi0 = fa + fb, p1 = -(a fa + b fb), p2 = -(b fa + a fb),
    # phil = fa sa + fb sb
    dfa = dphi0 - dp1 * a - dp2 * b + dphil * sa
    dfb = dphi0 - dp1 * b - dp2 * a + dphil * sb
    s_a = 2.0 * (a + b * c12)
    s_b = 2.0 * (b + a * c12)
    da = (-dp1 * fa - dp2 * fb
          + dphil * (fa * (s_a - 2.0 * i1) + fb * (s_a - 2.0 * i2))
          - r1 * fa * dfa - r2 * fb * dfb)
    db = (-dp1 * fb - dp2 * fa
          + dphil * (fa * (s_b - 2.0 * i2) + fb * (s_b - 2.0 * i1))
          - r2 * fa * dfa - r1 * fb * dfb)

    dl, dzl = _mlp_vjp(t0, cf, l_w[0], l_w[2], l_w[4], l_act,
                       (dq0, dl1, dl2))
    dm, dzm = _mlp_vjp(e0, cf, m_w[0], m_w[2], m_w[4], m_act,
                       (dq0, dm1, dm2))
    grads = (tuple(dl) + tuple(dm), da, db)
    if not point_grads:
        return grads

    # the MLPs' inputs: s = t (lambda) or eta^2 (mu), and cf = R/4 (both)
    ds_l, ds_m = dzl @ l_w[0][0], dzm @ m_w[0][0]
    dcf = dzl @ l_w[0][1] + dzm @ m_w[0][1]
    # the top's features: qq, ql, gpt = kt (p1 + p2), gpe = ke (p1 - p2)
    dtl = dql * l1
    dgtt = dqq * l1 * l1 + dql * l_tr[2]
    del2 = dql * m1
    dgee = dqq * m1 * m1 + dql * m_tr[2]
    dkt = dgpt * (p1 + p2)
    dke = dgpe * (p1 - p2)
    # the GZ pair in the geometry (fa, fb, and sa, sb through phil)
    dsa, dsb = dphil * fa, dphil * fb
    dr1 = -(a * fa * dfa + b * fb * dfb)
    dr2 = -(b * fa * dfa + a * fb * dfb)
    dc12 = 2.0 * a * b * (dsa + dsb)
    di1 = -2.0 * (a * dsa + b * dsb)
    di2 = -2.0 * (b * dsa + a * dsb)
    # t0 = e^{R - (r1+r2)/2} with tl, gtt, kt
    hc = 1.0 + c12
    dt0 = (ds_l + dtl * (0.5 * hc - (i1 + i2)) + dgtt * t0 * hc
           - 0.5 * dkt * hc)
    dc12 = dc12 + 0.5 * t0 * (dtl + dgtt * t0 - dkt)
    di1 = di1 - dtl * t0
    di2 = di2 - dtl * t0
    dex = dt0 * t0
    dr = dex + 0.25 * dcf
    dr1 = dr1 - 0.5 * dex
    dr2 = dr2 - 0.5 * dex
    # ev = (r1 - r2)/(2R), eta^2 = ev^2, el2, gee, ke
    inv_r = 1.0 / r
    ev = (r1 - r2) * (0.5 * inv_r)
    mc = 1.0 - c12
    de0 = ds_m + dgee * 2.0 * mc * inv_r * inv_r
    dev = (2.0 * ev * de0 + del2 * 2.0 * (i1 - i2) * inv_r
           + dke * inv_r * mc)
    di1 = di1 + del2 * 2.0 * ev * inv_r
    di2 = di2 - del2 * 2.0 * ev * inv_r
    dc12 = dc12 - (del2 + 2.0 * e0 * dgee) * inv_r * inv_r - dke * ev * inv_r
    dinv = (del2 * (2.0 * ev * (i1 - i2) + 2.0 * mc * inv_r)
            + dgee * 4.0 * e0 * mc * inv_r + dke * ev * mc
            + dev * 0.5 * (r1 - r2))
    dr1 = dr1 + 0.5 * dev * inv_r - di1 * i1 * i1
    dr2 = dr2 - 0.5 * dev * inv_r - di2 * i2 * i2
    dr = dr - dinv * inv_r * inv_r
    dx, dy, dz, dr_g = geometry_vjp(x, y, z, r, ry, rz, i1, i2, c12, dr1,
                                    dr2, dc12)
    return grads + (dx, dy, dz, dr + dr_g)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/separable_fwd.cu, csrc/separable_bwd.cu)

# The kernels' work layout (csrc/separable.cuh): blocks of THREADS threads,
# min(8, H) threads a point, so a tile of THREADS // min(8, H) points.
THREADS = 256
# K1-bwd's grid has at most this many blocks per SM of an H100 (132 SMs):
# the resident blocks its __launch_bounds__ asks for, so one wave.
GRID_BLOCKS_PER_SM, N_SM = 2, 132


def points_per_tile(hidden: int) -> int:
    """Points a block evaluates at a time."""
    return THREADS // min(8, hidden)


def n_tiles(n: int, hidden: int) -> int:
    """Tiles of n points; the last one is padded."""
    return -(-n // points_per_tile(hidden))


def grid_blocks(n: int, hidden: int) -> int:
    """Blocks of a K1-bwd launch: one a tile, at most GRID_BLOCKS_PER_SM *
    N_SM; each block walks the tiles blockIdx, blockIdx + grid, ... in
    order. The count depends on n and H alone, so the rows of partial
    weight gradients (one a block), their order, and so the bits do too.
    K1-fwd sums nothing across points and takes one block a tile."""
    return max(1, min(n_tiles(n, hidden), GRID_BLOCKS_PER_SM * N_SM))


def _lib(name: str):
    """The typed library of K1-fwd (its extra int: the tiles) or K1-bwd
    (the grid and the point-gradient flag), its tiles checked against
    points_per_tile once."""
    fwd = name == "separable_fwd"
    return _cuda.tiled_lib(name, 9 if fwd else 16, "separable",
                           lambda h, _dtype: points_per_tile(h),
                           n_extra_int=1 if fwd else 2)


def occupancy(name: str, hidden: int, dtype,
              point_grads: bool = False) -> tuple[int, int]:
    """(resident blocks per SM, shared memory bytes per block) of kernel
    ``name`` ("separable_fwd" or "separable_bwd", and of the latter's
    point-gradient instantiation) at this width and dtype on the current
    card."""
    return _cuda.occupancy(_lib(name), hidden, dtype, point_grads)


def separable_fwd_cuda(weights, a, b, x, y, z, r, *, p_sym: int = 1,
                       ry: float = 0.0, rz: float = 0.0):
    """K1 forward on the card: (psi, lap) for CUDA tensors."""
    hidden = weights[0].shape[1]
    pts = (x, y, z, r, a, b)
    _cuda.check_inputs(hidden, weights, weight_shapes(hidden), pts)
    pts = [t.contiguous() for t in pts]
    n = pts[0].shape[0]
    psi = torch.empty_like(pts[0])
    lap = torch.empty_like(pts[0])
    lib = _lib("separable_fwd")
    _cuda.launch(lib, pts[0].dtype, pts[0].device,
                 (*pts, _cuda.pack(weights), psi, lap), n, hidden, p_sym,
                 ry, rz, extra_ints=(max(1, n_tiles(n, hidden)),))
    launches["separable_fwd"] += 1
    return psi, lap


def separable_bwd_cuda(weights, a, b, x, y, z, r, dpsi, dlap, *,
                       p_sym: int = 1, ry: float = 0.0, rz: float = 0.0,
                       point_grads: bool = False):
    """K1 backward on the card: (12 weight grads, da, db), and with
    ``point_grads`` also (dx, dy, dz, dr) from the kernel's point-gradient
    instantiation. Each block writes one row of partial weight gradients,
    summed in a fixed order (no atomics); the rows are summed here —
    repeatable bit for bit."""
    hidden = weights[0].shape[1]
    pts = (x, y, z, r, a, b)
    shapes = weight_shapes(hidden)
    _cuda.check_inputs(hidden, weights, shapes, pts + (dpsi, dlap))
    pts = [t.contiguous() for t in pts]
    dpsi, dlap = dpsi.contiguous(), dlap.contiguous()
    n = pts[0].shape[0]
    lib = _lib("separable_bwd")
    grid = grid_blocks(n, hidden)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    partials = torch.empty((grid, sum(sizes)), dtype=pts[0].dtype,
                           device=pts[0].device)
    da = torch.empty_like(pts[0])
    db = torch.empty_like(pts[0])
    dpts = tuple(torch.empty_like(pts[0]) if point_grads else None
                 for _ in range(4))
    _cuda.launch(lib, pts[0].dtype, pts[0].device,
                 (*pts, _cuda.pack(weights), dpsi, dlap, da, db, partials,
                  *dpts), n, hidden, p_sym, ry, rz,
                 extra_ints=(grid, int(point_grads)))
    launches["separable_bwd_pg" if point_grads else "separable_bwd"] += 1
    dws = tuple(g.reshape(s) for g, s in
                zip(torch.split(partials.sum(0), sizes), shapes))
    return (dws, da, db) + (dpts if point_grads else ())


# ---------------------------------------------------------------------------
# autograd.Function and the training entry point


class SeparableKernel(torch.autograd.Function):
    """(psi, lap) = K1(a, b, x, y, z, r; weights) with its hand-written
    backward. cfg = (p_sym, ry, rz, point_grads). Gradients flow to the 12
    weights and to a, b; to the points x, y, z, r only with point_grads
    (otherwise they are constants)."""

    @staticmethod
    def forward(ctx, cfg, a, b, x, y, z, r, *weights):
        p_sym, ry, rz, _ = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(a, b, x, y, z, r, *weights)
        kw = dict(p_sym=p_sym, ry=ry, rz=rz)
        if a.is_cuda:
            return separable_fwd_cuda(weights, a, b, x, y, z, r, **kw)
        return psi_lap_separable_plain(weights, a, b, x, y, z, r, **kw)

    @staticmethod
    def backward(ctx, dpsi, dlap):
        a, b, x, y, z, r, *weights = ctx.saved_tensors
        p_sym, ry, rz, point_grads = ctx.cfg
        kw = dict(p_sym=p_sym, ry=ry, rz=rz, point_grads=point_grads)
        vjp = separable_bwd_cuda if a.is_cuda else psi_lap_separable_vjp_plain
        dws, da, db, *dpts = vjp(weights, a, b, x, y, z, r, dpsi, dlap, **kw)
        return (None, da, db, *(dpts or (None,) * 4)) + tuple(dws)


def kernel_weights(params: dict, dtype) -> tuple:
    """The 12 kernel weights from a params tree: cast to the point dtype,
    biases reshaped to (1, H)."""
    return tuple(params[k][f].reshape(
        (1, -1) if f == "b" else params[k][f].shape).to(dtype)
        for k, f in _W_NAMES)


def psi_lap_train_separable(params: dict, mcfg, x, y, z, r,
                            point_grads: bool = False):
    """(psi, lap, E) through the fused separable kernel. The R-only heads
    (E, alpha, b) run and differentiate in torch autograd; the spatial
    network runs in the kernel through SeparableKernel, so autograd of any
    loss composes exactly. By default the point coordinates are constants
    (training treats the batch as data); with ``point_grads`` gradients
    flow to x, y, z and r too, r's through the kernel and the heads."""
    ansatz.check_supported(params, mcfg)
    if "lam1" not in params:
        raise NotImplementedError(
            "not separable params: the symmetric family's kernel is "
            "ops.pallas_train.psi_lap_train")
    dtype = x.dtype
    r_pts = r
    if not point_grads:
        x, y, z, r_pts = (t.detach() for t in (x, y, z, r))
    e = ansatz.energy(params, r)
    a = ansatz.orbital_exponent(params, r)
    b = ansatz.gz_exponent(params, r, mcfg.inversion_symmetry, a)
    cfg = (int(mcfg.inversion_symmetry), float(mcfg.ry), float(mcfg.rz),
           bool(point_grads))
    psi, lap = SeparableKernel.apply(cfg, a.to(dtype), b.to(dtype),
                                     x, y, z, r_pts,
                                     *kernel_weights(params, dtype))
    return psi, lap, e
