"""The parametric H2+ ansatz psi(x, y, z; R) and its heads.

The PyTorch counterpart of the three families of the JAX package's
``models/ansatz.py``:

- ``symmetric`` (the paper model):

      psi = gate(R) * NN_sym(x, y, z, R) + LCAO(x, y, z, R)
      NN_sym = Lin_out( base(f1, f2) + P * base(f1m, f2m) )   (mirror x -> -x)

  with envelopes f = exp(-a r), a = alpha(R) (``trainable_exponent``) or 1,
  and LCAO = f1 + P f2, or the Guillemin-Zener part exp(-a r1 - b r2) +
  P exp(-a r2 - b r1) with trainable b(R) (``gz``). The output bias applies
  in the gerade sector only (exact antisymmetry for P = -1).
- ``minimal`` (the reference's ``train.py``): no mirrored branch,

      psi = f1 + f2 + gate(R) * Lin_out( 2 base(f1, f2) )

  with no parity factor; keyed by the config (``arch``), since its params
  have the symmetric family's tree.
- ``separable``:

      psi = Phi_GZ(x, y, z; R) * exp( 3 tanh( (l(t, R/4) + m(eta^2, R/4)) / 3 ) )

  Phi_GZ as above with trainable a(R), b(R); t = e^{R - (r1+r2)/2} and
  eta^2 = ((r1-r2)/(2R))^2 are the prolate-spheroidal features; l and m are
  width-H tanh MLPs with zero-initialised output layers, so the init is
  exactly the GZ physics ansatz.

  The excited-state factors multiply this psi: a radial node
  ((r1+r2)/2 - R xi0(R)) (params ``rnode*``, or the legacy ``node*``), a
  second one a bounded gap beyond it (``rnodeb*``), an angular node
  (eta^2 - eta0^2(R)) (``enode*``), and the harmonic transverse factor
  Re[(y + i z)^m] of an |m| = ``m_abs`` state (keyed by the config, not
  the params).

The symmetric and minimal bases take R/4 as a third feature when ``h1``
has three input rows (``r_input``): the weight shape decides, so
checkpoints describe themselves. E(R) is a sigmoid MLP head in all three.
Parameters are plain nested dicts ``{name: {"w": (d_in, d_out), "b":
(d_out,)}}`` of tensors, the JAX package's layout (y = x @ w + b), so
``from_jax_params`` / ``to_numpy_params`` map one to one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device, resolve_dtype
from ..io.checkpoint import as_numpy, as_tensor
from ..ops import fwdlap

# ---------------------------------------------------------------------------
# Parameters


def from_jax_params(tree: dict, dtype=None, device="cuda") -> dict:
    """Port params from the JAX layout ``{name: {"w", "b"}}`` of numpy
    arrays (or anything ``np.asarray`` takes; the 2-byte bits of a bfloat16
    leaf of ``to_numpy_params`` too). ``dtype`` None keeps each array's own
    float type. Each leaf is converted once from its own type: to bfloat16
    by torch's rounding, which takes a float64 value through float32 as
    ml_dtypes does (the JAX CLI's ``np.asarray(a, jnp.bfloat16)``), so the
    two packages' bfloat16 params agree bit for bit."""
    dev = resolve_device(device)
    dt = None if dtype is None else resolve_dtype(dtype)

    def leaf(a):
        t = as_tensor(a)
        return t.to(device=dev, dtype=dt or t.dtype)

    return {k: {f: leaf(a) for f, a in v.items()} for k, v in tree.items()}


def as_params(params: dict, dtype, device) -> dict:
    """Port params on ``device`` in ``dtype`` (fresh tensors) from port
    params or from the JAX layout of numpy arrays."""
    leaf = next(iter(next(iter(params.values())).values()))
    if isinstance(leaf, torch.Tensor):
        return {k: {f: t.detach().to(device=device, dtype=dtype).clone()
                    for f, t in v.items()} for k, v in params.items()}
    return from_jax_params(params, dtype=dtype, device=device)


def to_numpy_params(params: dict) -> dict:
    """The JAX layout of numpy arrays from port params; a bfloat16 leaf as
    the 2-byte void array of its bits (``io.checkpoint.as_numpy``), which a
    checkpoint writes as the JAX package does."""
    return {k: {f: as_numpy(t) for f, t in v.items()}
            for k, v in params.items()}


def _uniform(gen, shape, bound, dtype):
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    return ((2.0 * u - 1.0) * bound).to(dtype)


def _init_linear(gen, d_in, d_out, dtype, bias_bound=None):
    """torch.nn.Linear default init: U(+/- 1/sqrt(fan_in)) for the weight,
    and for the bias unless ``bias_bound`` is given."""
    bound = 1.0 / float(np.sqrt(d_in))
    return {"w": _uniform(gen, (d_in, d_out), bound, dtype),
            "b": _uniform(gen, (d_out,),
                          bound if bias_bound is None else bias_bound,
                          dtype)}


def init_params(mcfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> dict:
    """Parameter tree of the ``mcfg.arch`` family, drawn from a CPU
    ``torch.Generator`` seeded with ``seed`` (so the draw is the same on
    every device), then moved to ``device``. The JAX package draws from
    ``jax.random``: the two inits differ for the same seed."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    init = _init_separable if mcfg.arch == "separable" else _init_symmetric
    params = init(gen, mcfg, resolve_dtype(dtype))
    return {k: {f: t.to(dev) for f, t in v.items()}
            for k, v in params.items()}


def _zero_out(width, bias, dtype):
    """Zero weights and a constant bias: the head's output is ``bias``."""
    return {"w": torch.zeros((width, 1), dtype=dtype),
            "b": torch.full((1,), bias, dtype=dtype)}


def _init_symmetric(gen, mcfg: ModelConfig, dtype) -> dict:
    """Symmetric and minimal families. Symmetric: torch.nn.Linear defaults
    everywhere and the E-head output bias at ``eout_bias_init`` (-1).
    Minimal (the reference's train.py): every tensor from U(+/- 1/sqrt(
    shape[0])), so the biases from U(+/- 1/sqrt(fan_out)), and no bias
    override. Both: the alpha/beta heads with torch defaults and zero output
    weights so that alpha(R) == 1 and b(R) == 0.1 at init, and a 3-input
    ``h1`` for ``r_input``."""
    h, he, hg, ha = mcfg.hidden, mcfg.hidden_e, mcfg.hidden_gate, \
        mcfg.hidden_alpha
    minimal = mcfg.arch == "minimal"

    def lin(a, b):
        return _init_linear(gen, a, b, dtype,
                            1.0 / float(np.sqrt(b)) if minimal else None)

    params = {
        "h1": lin(3 if mcfg.r_input else 2, h),
        "h2": lin(h, h),
        "out": lin(h, 1),
        "e1": lin(1, he),
        "e2": lin(he, he),
        "eout": lin(he, 1),
        "gate1": lin(1, hg),
        "gate2": lin(hg, 1),
    }
    if not minimal:
        params["eout"]["b"] = torch.full((1,), mcfg.eout_bias_init,
                                         dtype=dtype)
    if mcfg.trainable_exponent:
        params["alpha1"] = _init_linear(gen, 1, ha, dtype)
        params["alpha2"] = _zero_out(ha, ALPHA_BIAS_INIT, dtype)
    if mcfg.gz:
        params["beta1"] = _init_linear(gen, 1, ha, dtype)
        params["beta2"] = _zero_out(ha, BETA_BIAS_INIT, dtype)
    return params


def _init_separable(gen, mcfg: ModelConfig, dtype) -> dict:
    """Separable-spheroidal family: zero-initialised output layers make the
    init EXACTLY the GZ physics ansatz."""
    h, he, ha = mcfg.hidden, mcfg.hidden_e, mcfg.hidden_alpha

    def lin(a, b):
        return _init_linear(gen, a, b, dtype)

    params = {
        "e1": lin(1, he),
        "e2": lin(he, he),
        "eout": lin(he, 1),
        "lam1": lin(2, h),
        "lam2": lin(h, h),
        "lamout": _zero_out(h, 0.0, dtype),
        "mu1": lin(2, h),
        "mu2": lin(h, h),
        "muout": _zero_out(h, 0.0, dtype),
    }
    a_key = "xalpha" if mcfg.wide_alpha else "alpha"
    a_bias = XALPHA_BIAS_INIT if mcfg.wide_alpha else ALPHA_BIAS_INIT
    params[a_key + "1"] = lin(1, ha)
    params[a_key + "2"] = _zero_out(ha, a_bias, dtype)
    params["beta1"] = lin(1, ha)
    params["beta2"] = _zero_out(ha, BETA_BIAS_INIT, dtype)
    params["eout"]["b"] = torch.full((1,), mcfg.eout_bias_init, dtype=dtype)
    if mcfg.xi_node:
        # the R-aware radial node (node_xi0); the legacy "node*" form is
        # read from shipped checkpoints only
        params["rnode1"] = lin(1, ha)
        params["rnode2"] = _zero_out(ha, RNODE_BIAS_INIT, dtype)
    if mcfg.eta_node:
        params["enode1"] = lin(1, ha)
        params["enode2"] = _zero_out(ha, ETA_NODE_BIAS_INIT, dtype)
    if mcfg.xi_node2:
        if not mcfg.xi_node:
            raise ValueError("xi_node2 (second radial node) requires "
                             "xi_node")
        params["rnodeb1"] = lin(1, ha)
        params["rnodeb2"] = _zero_out(ha, RNODEB_BIAS_INIT, dtype)
    return params


# ---------------------------------------------------------------------------
# R-only heads


def _mlp2(x, l1, l2, l3=None):
    """sigmoid MLP: sig(x@w1+b1) -> sig(.@w2+b2) [-> .@w3+b3]."""
    y = torch.sigmoid(x @ l1["w"] + l1["b"])
    y = torch.sigmoid(y @ l2["w"] + l2["b"])
    if l3 is not None:
        y = y @ l3["w"] + l3["b"]
    return y


def energy(params: dict, r: torch.Tensor) -> torch.Tensor:
    """E(R) eigenvalue head. r: (...,)."""
    return _mlp2(r[..., None], params["e1"], params["e2"],
                 params["eout"])[..., 0]


def gate(params: dict, r: torch.Tensor) -> torch.Tensor:
    """Gate ('network importance') g(R) of the symmetric family."""
    y = torch.sigmoid(r[..., None] @ params["gate1"]["w"]
                      + params["gate1"]["b"])
    return (y @ params["gate2"]["w"] + params["gate2"]["b"])[..., 0]


# alpha(R) = 1.5 + 0.75 tanh(head) in (0.75, 2.25); the head's zero weights
# and this bias give alpha == 1 at init
_ALPHA_MID, _ALPHA_HALF = 1.5, 0.75
ALPHA_BIAS_INIT = float(np.arctanh((1.0 - _ALPHA_MID) / _ALPHA_HALF))
# wide range (0.3, 2.25) for "xalpha*" params
_XALPHA_MID, _XALPHA_HALF = 1.275, 0.975
XALPHA_BIAS_INIT = float(np.arctanh((1.0 - _XALPHA_MID) / _XALPHA_HALF))
# second GZ exponent b(R) in (0, 1.5), initialised to 0.1
_BETA_HALF = 0.75
BETA_BIAS_INIT = float(np.arctanh(0.1 / _BETA_HALF - 1.0))


def _head(params, name, r):
    a = torch.sigmoid(r[..., None] @ params[name + "1"]["w"]
                      + params[name + "1"]["b"])
    return (a @ params[name + "2"]["w"] + params[name + "2"]["b"])[..., 0]


def orbital_exponent(params: dict, r: torch.Tensor) -> torch.Tensor:
    """alpha(R) = 1.5 + 0.75 tanh(head(R)), or 1.275 + 0.975 tanh(head) for
    "xalpha*" params; exactly 1 when the head is absent."""
    if "xalpha1" in params:
        return _XALPHA_MID + _XALPHA_HALF * torch.tanh(
            _head(params, "xalpha", r))
    if "alpha1" not in params:
        return torch.ones_like(r)
    return _ALPHA_MID + _ALPHA_HALF * torch.tanh(_head(params, "alpha", r))


def gz_exponent(params: dict, r: torch.Tensor, p_sym: int = 1,
                alpha=None) -> torch.Tensor:
    """Second GZ exponent b(R); 0 means pure LCAO.

    gerade (p_sym=+1): b = 0.75 (1 + tanh(head)) in (0, 1.5).
    ungerade (p_sym=-1): b = (a - 0.25) (1 + tanh(head)) / 2 < a, since at
    b = a the antisymmetric GZ part vanishes identically (a psi = 0
    collapse mode)."""
    if "beta1" not in params:
        return torch.zeros_like(r)
    h = _head(params, "beta", r)
    if p_sym >= 0:
        return _BETA_HALF * (1.0 + torch.tanh(h))
    alpha = torch.ones_like(r) if alpha is None else alpha
    return (alpha - 0.25) * 0.5 * (1.0 + torch.tanh(h))


# Radial node xi0(R) = 1 + XI0_CAP sigmoid(head) of the legacy "node*"
# params: the cap keeps the node inside the quadrature span
XI0_CAP = 8.0
NODE_BIAS_INIT = float(np.log(1.0 / (XI0_CAP - 1.0)))  # xi0 == 2 at init
# R-aware radial node ("rnode*"): the node's physical radius R xi0 =
# R + RNODE_CAP sigmoid(head), a bounded distance beyond the foci at every R
RNODE_CAP = 12.0
RNODE_BIAS_INIT = float(np.log(0.2))  # node at R + 2 bohr at init
# second radial node ("rnodeb*"): a gap in (RNODEB_GAP_LO, RNODEB_GAP_LO +
# RNODEB_CAP) bohr beyond the first; the positive floor keeps both zeros
# simple. Init gap 2.5 bohr
RNODEB_CAP = 8.0
RNODEB_GAP_LO = 0.3
RNODEB_BIAS_INIT = float(np.log(2.2 / (RNODEB_CAP - 2.2)))
# angular node eta0^2(R) = sigmoid(head) in (0, 1), 1/3 at init (the P2
# Legendre nodes)
ETA_NODE_BIAS_INIT = float(np.log(0.5))


def node_xi0(params: dict, r: torch.Tensor) -> torch.Tensor:
    """Trainable node position xi0(R) (xi_node models); the psi factor is
    (p_half - r xi0) with p_half = (r1 + r2) / 2. "rnode*" params take the
    R-aware form 1 + (RNODE_CAP / r) sigmoid(head), legacy "node*" params
    1 + XI0_CAP sigmoid(head)."""
    if "rnode1" in params:
        return 1.0 + (RNODE_CAP / r) * torch.sigmoid(
            _head(params, "rnode", r))
    return 1.0 + XI0_CAP * torch.sigmoid(_head(params, "node", r))


def node_gap2(params: dict, r: torch.Tensor) -> torch.Tensor:
    """Physical gap (bohr) between the second and the first radial node
    (xi_node2 models): the second factor is (p_half - r xi0 - gap)."""
    return RNODEB_GAP_LO + RNODEB_CAP * torch.sigmoid(
        _head(params, "rnodeb", r))


def node_eta0sq(params: dict, r: torch.Tensor) -> torch.Tensor:
    """Squared angular node position eta0^2(R) (eta_node models): the
    factor (eta^2 - eta0^2) vanishes at eta = +-eta0."""
    return torch.sigmoid(_head(params, "enode", r))


def has_radial_node(params: dict) -> bool:
    """Whether the params carry a radial node head (legacy ``node*`` or
    ``rnode*``)."""
    return "node1" in params or "rnode1" in params


# The log-correction is bounded to |l + m| < 3: an unbounded exp correction
# has a quadrature-gaming mode under grid-trained variational objectives.
LOG_CORR_CAP = 3.0


# ---------------------------------------------------------------------------
# Forward passes


def _mlp_tanh(x, l1, l2, l3):
    """tanh MLP with linear output (the separable log-correction bodies)."""
    y = torch.tanh(x @ l1["w"] + l1["b"])
    y = torch.tanh(y @ l2["w"] + l2["b"])
    return y @ l3["w"] + l3["b"]


def _psi_separable(params: dict, mcfg: ModelConfig, x, y, z, r):
    """Value-only forward of the separable-spheroidal family."""
    p_sym = mcfg.inversion_symmetry
    r1 = torch.sqrt((x - r) ** 2 + (y - mcfg.ry) ** 2 + (z - mcfg.rz) ** 2)
    r2 = torch.sqrt((x + r) ** 2 + (y + mcfg.ry) ** 2 + (z + mcfg.rz) ** 2)
    a = orbital_exponent(params, r)
    b = gz_exponent(params, r, p_sym, a)
    phi = torch.exp(-a * r1 - b * r2) + p_sym * torch.exp(-a * r2 - b * r1)
    p_half = 0.5 * (r1 + r2)              # c*xi
    t = torch.exp(r - p_half)             # e^{-c(xi-1)} in (0, 1]
    eta2 = (0.5 * (r1 - r2) / r) ** 2
    r_feat = 0.25 * r
    lam = _mlp_tanh(torch.stack([t, r_feat], -1),
                    params["lam1"], params["lam2"], params["lamout"])
    mu = _mlp_tanh(torch.stack([eta2, r_feat], -1),
                   params["mu1"], params["mu2"], params["muout"])
    c = LOG_CORR_CAP
    log_corr = c * torch.tanh((lam[..., 0] + mu[..., 0]) / c)
    out = phi * torch.exp(log_corr)
    if has_radial_node(params):
        # one simple zero on the xi = xi0(R) ellipsoid
        out = out * (p_half - r * node_xi0(params, r))
        if "rnodeb1" in params:
            out = out * (p_half - r * node_xi0(params, r)
                         - node_gap2(params, r))
    if "enode1" in params:
        # angular nodes at eta = +-eta0(R); eta^2 is even under inversion
        out = out * (eta2 - node_eta0sq(params, r))
    if mcfg.m_abs:
        out = out * transverse_harmonic(mcfg.m_abs, y, z)[0]
    return out, energy(params, r)


def transverse_harmonic(m: int, y, z):
    """Re[(y + i z)^m], the transverse factor of an |m| state (molecular
    axis along x): y for pi, y^2 - z^2 for delta. Inversion-odd iff m is
    odd. Returns (value, d/dy, d/dz); its laplacian is zero (a harmonic
    polynomial). The separable kernel's plain versions and its factor
    epilogue use the same recurrences (ops/pallas_separable.py,
    csrc/separable.cuh)."""
    re, im = y, z
    for _ in range(m - 1):
        re, im = re * y - im * z, re * z + im * y
    # grad Re w^m = m (Re w^{m-1}, -Im w^{m-1})
    if m == 1:
        return re, torch.ones_like(y), torch.zeros_like(z)
    rp, ip = y, z
    for _ in range(m - 2):
        rp, ip = rp * y - ip * z, rp * z + ip * y
    return re, m * rp, -m * ip


def _envelopes(mcfg: ModelConfig, x, y, z, r, mirror_x=False, alpha=None):
    """exp(-alpha r1), exp(-alpha r2) for nuclei at (+/-R, +/-ry, +/-rz);
    alpha None means 1."""
    xs = -x if mirror_x else x
    r1 = torch.sqrt((xs - r) ** 2 + (y - mcfg.ry) ** 2 + (z - mcfg.rz) ** 2)
    r2 = torch.sqrt((xs + r) ** 2 + (y + mcfg.ry) ** 2 + (z + mcfg.rz) ** 2)
    if alpha is None:
        return torch.exp(-r1), torch.exp(-r2)
    return torch.exp(-alpha * r1), torch.exp(-alpha * r2)


def lcao(mcfg: ModelConfig, x, y, z, r, params: dict | None = None):
    """Analytic LCAO part exp(-a r1) + P exp(-a r2); a = 1 unless the
    trainable exponent head is in ``params``."""
    alpha = None
    if params is not None and "alpha1" in params:
        alpha = orbital_exponent(params, r)
    f1, f2 = _envelopes(mcfg, x, y, z, r, alpha=alpha)
    return f1 + mcfg.inversion_symmetry * f2


def _r_feature(params: dict, r):
    """R/4 as the bases' third feature when ``h1`` has three input rows
    (``r_input``), else None."""
    return 0.25 * r if params["h1"]["w"].shape[0] == 3 else None


def _psi_symmetric(params: dict, mcfg: ModelConfig, x, y, z, r):
    """Value-only forward of the symmetric and minimal families."""
    e = energy(params, r)
    alpha = orbital_exponent(params, r) if "alpha1" in params else None
    f1, f2 = _envelopes(mcfg, x, y, z, r, alpha=alpha)
    g = gate(params, r)
    r_feat = _r_feature(params, r)

    def base(a, b):
        feats = [a, b] + ([] if r_feat is None else [r_feat])
        return _mlp2(torch.stack(feats, dim=-1), params["h1"], params["h2"])

    if mcfg.arch == "minimal":
        nn = (2.0 * base(f1, f2)) @ params["out"]["w"] + params["out"]["b"]
        return f1 + f2 + nn[..., 0] * g, e
    f1m, f2m = _envelopes(mcfg, x, y, z, r, mirror_x=True, alpha=alpha)
    b = base(f1, f2) + mcfg.inversion_symmetry * base(f1m, f2m)
    nn = b @ params["out"]["w"]
    if mcfg.inversion_symmetry > 0:
        # the output bias breaks exact antisymmetry for P = -1, so it
        # applies in the gerade sector only
        nn = nn + params["out"]["b"]
    if "beta1" in params:
        a_ = alpha if alpha is not None else torch.ones_like(r)
        bt = gz_exponent(params, r, mcfg.inversion_symmetry, a_)
        r1 = torch.sqrt((x - r) ** 2 + (y - mcfg.ry) ** 2 + (z - mcfg.rz) ** 2)
        r2 = torch.sqrt((x + r) ** 2 + (y + mcfg.ry) ** 2 + (z + mcfg.rz) ** 2)
        n_lcao = (torch.exp(-a_ * r1 - bt * r2)
                  + mcfg.inversion_symmetry * torch.exp(-a_ * r2 - bt * r1))
    else:
        n_lcao = f1 + mcfg.inversion_symmetry * f2
    return nn[..., 0] * g + n_lcao, e


def psi(params: dict, mcfg: ModelConfig, x, y, z, r):
    """Full ansatz forward: returns (psi, E), both shaped like x.
    x, y, z, r: (...,) tensors (R the half internuclear distance)."""
    if "lam1" in params:
        return _psi_separable(params, mcfg, x, y, z, r)
    return _psi_symmetric(params, mcfg, x, y, z, r)


def _psi_separable_fwdlap(params: dict, mcfg: ModelConfig, x, y, z, r):
    """Fused forward-Laplacian pass of the separable-spheroidal family."""
    p_sym = float(mcfg.inversion_symmetry)
    a = orbital_exponent(params, r)
    b = gz_exponent(params, r, mcfg.inversion_symmetry, a)
    ones = torch.ones_like(r)
    c1 = (r, mcfg.ry * ones, mcfg.rz * ones)
    c2 = (-r, -mcfg.ry * ones, -mcfg.rz * ones)
    phi = fwdlap.add(fwdlap.gz_envelope(x, y, z, c1, c2, a, b),
                     fwdlap.scale(fwdlap.gz_envelope(x, y, z, c2, c1, a, b),
                                  p_sym))
    r1s = fwdlap.radial_seed(x, y, z, *c1)
    r2s = fwdlap.radial_seed(x, y, z, *c2)
    # t = e^{r - (r1+r2)/2}; eta^2 = ((r1-r2)/(2r))^2; both even under
    # r1 <-> r2 exchange, so Phi alone carries the inversion parity
    p_half = fwdlap.scale(fwdlap.add(r1s, r2s), 0.5)
    t = fwdlap.exp(fwdlap.add(fwdlap.scale(p_half, -1.0),
                              fwdlap.const(r[..., None])))
    eta = fwdlap.scale(fwdlap.sub(r1s, r2s), (0.5 / r)[..., None])
    eta2 = fwdlap.mul(eta, eta)
    r_feat = fwdlap.const((0.25 * r)[..., None])

    def body(s, l1, l2, l3):
        # the only spatial input is the scalar s: run on 1-D triples and
        # apply the chain rule once
        tr = fwdlap.seed1d(s.v, [r_feat.v], params[l1]["w"], params[l1]["b"])
        tr = fwdlap.tanh1d(tr)
        tr = fwdlap.tanh1d(fwdlap.linear1d(tr, params[l2]["w"],
                                           params[l2]["b"]))
        return fwdlap.chain(
            fwdlap.linear1d(tr, params[l3]["w"], params[l3]["b"]), s)

    lam = body(t, "lam1", "lam2", "lamout")
    mu = body(eta2, "mu1", "mu2", "muout")
    c = LOG_CORR_CAP
    bounded = fwdlap.scale(
        fwdlap.tanh(fwdlap.scale(fwdlap.add(lam, mu), 1.0 / c)), c)
    out = fwdlap.mul(phi, fwdlap.exp(bounded))
    if has_radial_node(params):
        q = fwdlap.add(p_half,
                       fwdlap.const(-(r * node_xi0(params, r))[..., None]))
        out = fwdlap.mul(out, q)
        if "rnodeb1" in params:
            q2 = fwdlap.add(
                p_half, fwdlap.const(-(r * node_xi0(params, r)
                                       + node_gap2(params, r))[..., None]))
            out = fwdlap.mul(out, q2)
    if "enode1" in params:
        q = fwdlap.add(eta2,
                       fwdlap.const(-node_eta0sq(params, r)[..., None]))
        out = fwdlap.mul(out, q)
    if mcfg.m_abs:
        # harmonic: the gradient is closed-form and the laplacian zero
        h, gy, gz = transverse_harmonic(mcfg.m_abs, y, z)
        zero = torch.zeros_like(h)
        hs = fwdlap.Spatial(h[..., None],
                            torch.stack([zero, gy, gz], dim=-1)[..., None],
                            zero[..., None])
        out = fwdlap.mul(out, hs)
    return out, energy(params, r)


def _base_fwdlap(params: dict, s: fwdlap.Spatial) -> fwdlap.Spatial:
    s = fwdlap.sigmoid(fwdlap.linear(s, params["h1"]["w"], params["h1"]["b"]))
    return fwdlap.sigmoid(fwdlap.linear(s, params["h2"]["w"],
                                        params["h2"]["b"]))


def _flip_gx(s: fwdlap.Spatial) -> fwdlap.Spatial:
    """Gradients taken in (-x, y, z) as gradients in (x, y, z): negate the
    x row. The laplacian is mirror-invariant."""
    # made on the device (no host copy, which a CUDA graph cannot capture)
    sign = torch.ones((3, 1), dtype=s.g.dtype, device=s.g.device)
    sign[0] = -1.0
    return fwdlap.Spatial(s.v, s.g * sign, s.l)


def _psi_symmetric_fwdlap(params: dict, mcfg: ModelConfig, x, y, z, r):
    """Fused forward-Laplacian pass of the symmetric and minimal
    families."""
    e = energy(params, r)
    g_r = gate(params, r)[..., None]      # (..., 1), spatially constant
    p = float(mcfg.inversion_symmetry)
    alpha = orbital_exponent(params, r) if "alpha1" in params else None
    f1 = fwdlap.orbital_envelope(x, y, z, r, mcfg.ry, mcfg.rz, alpha)
    f2 = fwdlap.orbital_envelope(x, y, z, -r, -mcfg.ry, -mcfg.rz, alpha)
    r_feat = _r_feature(params, r)
    extra = [] if r_feat is None else [fwdlap.const(r_feat[..., None])]
    if mcfg.arch == "minimal":
        s = _base_fwdlap(params, fwdlap.concat([f1, f2] + extra))
        s = fwdlap.linear(fwdlap.scale(s, 2.0), params["out"]["w"],
                          params["out"]["b"])
        return fwdlap.add(fwdlap.add(f1, f2), fwdlap.scale(s, g_r)), e
    # the mirrored branch at -x, its gradients turned back to x
    f1m = _flip_gx(fwdlap.orbital_envelope(-x, y, z, r, mcfg.ry, mcfg.rz,
                                           alpha))
    f2m = _flip_gx(fwdlap.orbital_envelope(-x, y, z, -r, -mcfg.ry,
                                           -mcfg.rz, alpha))
    b = _base_fwdlap(params, fwdlap.concat([f1, f2] + extra))
    bm = _base_fwdlap(params, fwdlap.concat([f1m, f2m] + extra))
    # the output bias in the gerade sector only (exact antisymmetry)
    out_bias = params["out"]["b"] if mcfg.inversion_symmetry > 0 else None
    s = fwdlap.linear(fwdlap.add(b, fwdlap.scale(bm, p)), params["out"]["w"],
                      out_bias)
    s = fwdlap.scale(s, g_r)
    if "beta1" in params:
        a_ = alpha if alpha is not None else torch.ones_like(r)
        bt = gz_exponent(params, r, mcfg.inversion_symmetry, a_)
        ones = torch.ones_like(r)
        c1 = (r, mcfg.ry * ones, mcfg.rz * ones)
        c2 = (-r, -mcfg.ry * ones, -mcfg.rz * ones)
        n_lcao = fwdlap.add(fwdlap.gz_envelope(x, y, z, c1, c2, a_, bt),
                            fwdlap.scale(fwdlap.gz_envelope(x, y, z, c2, c1,
                                                            a_, bt), p))
    else:
        n_lcao = fwdlap.add(f1, fwdlap.scale(f2, p))
    return fwdlap.add(s, n_lcao), e


def psi_fwdlap(params: dict, mcfg: ModelConfig, x, y, z, r):
    """Fused pass returning (Spatial(psi), E): psi, grad psi and lap psi in
    one forward traversal, for every family: the path, on every device, of
    the models that no kernel carries, and the plain reference of the
    others (``ops.routing.kernel_of`` decides which are which)."""
    if "lam1" in params:
        return _psi_separable_fwdlap(params, mcfg, x, y, z, r)
    return _psi_symmetric_fwdlap(params, mcfg, x, y, z, r)


def param_count(params: dict) -> int:
    return sum(t.numel() for v in params.values() for t in v.values())
