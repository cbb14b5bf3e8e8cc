"""The parametric H2+ ansatz psi(x, y, z; R) and its heads.

The PyTorch counterpart of two families of the JAX package's
``models/ansatz.py``:

- ``symmetric`` (the paper model):

      psi = gate(R) * NN_sym(x, y, z, R) + LCAO(x, y, z, R)
      NN_sym = Lin_out( base(f1, f2) + P * base(f1m, f2m) )   (mirror x -> -x)

  with envelopes f = exp(-a r), a = alpha(R) (``trainable_exponent``) or 1,
  and LCAO = f1 + P f2, or the Guillemin-Zener part exp(-a r1 - b r2) +
  P exp(-a r2 - b r1) with trainable b(R) (``gz``). The output bias applies
  in the gerade sector only (exact antisymmetry for P = -1).
- ``separable``:

      psi = Phi_GZ(x, y, z; R) * exp( 3 tanh( (l(t, R/4) + m(eta^2, R/4)) / 3 ) )

  Phi_GZ as above with trainable a(R), b(R); t = e^{R - (r1+r2)/2} and
  eta^2 = ((r1-r2)/(2R))^2 are the prolate-spheroidal features; l and m are
  width-H tanh MLPs with zero-initialised output layers, so the init is
  exactly the GZ physics ansatz.

E(R) is a sigmoid MLP head in both. Parameters are plain nested dicts
``{name: {"w": (d_in, d_out), "b": (d_out,)}}`` of tensors, the JAX
package's layout (y = x @ w + b), so ``from_jax_params`` /
``to_numpy_params`` map one to one.

Not in this port yet (they raise NotImplementedError): the minimal family,
R-input (``r_input``) models, the node factors (``node*``, ``rnode*``,
``rnodeb*``, ``enode*``) and the |m| transverse factor (``m_abs``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device, resolve_dtype
from ..ops import fwdlap

# ---------------------------------------------------------------------------
# Parameters


def from_jax_params(tree: dict, dtype=None, device="cuda") -> dict:
    """Port params from the JAX layout ``{name: {"w", "b"}}`` of numpy
    arrays (or anything ``np.asarray`` takes). ``dtype`` None keeps each
    array's own float type."""
    dev = resolve_device(device)
    dt = None if dtype is None else resolve_dtype(dtype)

    def leaf(a):
        t = torch.as_tensor(np.array(a))
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
    """The JAX layout of numpy arrays from port params."""
    return {k: {f: t.detach().cpu().numpy() for f, t in v.items()}
            for k, v in params.items()}


def _uniform(gen, shape, bound, dtype):
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    return ((2.0 * u - 1.0) * bound).to(dtype)


def _init_linear(gen, d_in, d_out, dtype):
    """torch.nn.Linear default init: U(+/- 1/sqrt(fan_in)) for both weight
    and bias."""
    bound = 1.0 / float(np.sqrt(d_in))
    return {"w": _uniform(gen, (d_in, d_out), bound, dtype),
            "b": _uniform(gen, (d_out,), bound, dtype)}


def init_params(mcfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> dict:
    """Parameter tree of the symmetric or separable family, drawn from a
    CPU ``torch.Generator`` seeded with ``seed`` (so the draw is the same on
    every device), then moved to ``device``. The JAX package draws from
    ``jax.random``: the two inits differ for the same seed."""
    dev = resolve_device(device)
    _check_config(mcfg)
    gen = torch.Generator().manual_seed(int(seed))
    init = _init_separable if mcfg.arch == "separable" else _init_symmetric
    params = init(gen, mcfg, resolve_dtype(dtype))
    return {k: {f: t.to(dev) for f, t in v.items()}
            for k, v in params.items()}


def _check_config(mcfg: ModelConfig) -> None:
    if mcfg.arch == "minimal":
        raise NotImplementedError(
            "arch 'minimal' is not ported (symmetric and separable are)")
    if mcfg.r_input and mcfg.arch == "symmetric":
        raise NotImplementedError("R-input (r_input) models are not ported")
    if mcfg.xi_node or mcfg.xi_node2 or mcfg.eta_node or mcfg.m_abs:
        raise NotImplementedError(
            "node factors and the m_abs transverse factor are not ported")


def _zero_out(width, bias, dtype):
    """Zero weights and a constant bias: the head's output is ``bias``."""
    return {"w": torch.zeros((width, 1), dtype=dtype),
            "b": torch.full((1,), bias, dtype=dtype)}


def _init_symmetric(gen, mcfg: ModelConfig, dtype) -> dict:
    """Symmetric family: torch.nn.Linear defaults everywhere, the E-head
    output bias at ``eout_bias_init`` (-1), and the alpha/beta heads with
    zero output weights so that alpha(R) == 1 and b(R) == 0.1 at init."""
    h, he, hg, ha = mcfg.hidden, mcfg.hidden_e, mcfg.hidden_gate, \
        mcfg.hidden_alpha

    def lin(a, b):
        return _init_linear(gen, a, b, dtype)

    params = {
        "h1": lin(2, h),
        "h2": lin(h, h),
        "out": lin(h, 1),
        "e1": lin(1, he),
        "e2": lin(he, he),
        "eout": lin(he, 1),
        "gate1": lin(1, hg),
        "gate2": lin(hg, 1),
    }
    params["eout"]["b"] = torch.full((1,), mcfg.eout_bias_init, dtype=dtype)
    if mcfg.trainable_exponent:
        params["alpha1"] = lin(1, ha)
        params["alpha2"] = _zero_out(ha, ALPHA_BIAS_INIT, dtype)
    if mcfg.gz:
        params["beta1"] = lin(1, ha)
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


# The log-correction is bounded to |l + m| < 3: an unbounded exp correction
# has a quadrature-gaming mode under grid-trained variational objectives.
LOG_CORR_CAP = 3.0

_UNPORTED_KEYS = ("node1", "rnode1", "rnodeb1", "enode1")


def check_supported(params: dict, mcfg: ModelConfig) -> None:
    """Raise NotImplementedError for what this port does not run yet. The
    family is read off the params (lam*/mu* are separable), as the JAX
    package's forward passes dispatch."""
    if "lam1" not in params:
        if mcfg.arch != "symmetric":
            raise NotImplementedError(
                f"arch {mcfg.arch!r}: of the non-separable families only "
                "'symmetric' is ported")
        if params["h1"]["w"].shape[0] != 2:
            raise NotImplementedError(
                "R-input (r_input) models are not ported")
        return
    found = [k for k in _UNPORTED_KEYS if k in params]
    if found:
        raise NotImplementedError(
            f"node factors ({', '.join(found)}) are not ported")
    if mcfg.m_abs:
        raise NotImplementedError("the m_abs transverse factor is not ported")


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
    return phi * torch.exp(log_corr), energy(params, r)


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


def _psi_symmetric(params: dict, mcfg: ModelConfig, x, y, z, r):
    """Value-only forward of the symmetric family."""
    e = energy(params, r)
    alpha = orbital_exponent(params, r) if "alpha1" in params else None
    f1, f2 = _envelopes(mcfg, x, y, z, r, alpha=alpha)
    g = gate(params, r)
    f1m, f2m = _envelopes(mcfg, x, y, z, r, mirror_x=True, alpha=alpha)

    def base(a, b):
        return _mlp2(torch.stack([a, b], dim=-1), params["h1"], params["h2"])

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
    check_supported(params, mcfg)
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
    return out, energy(params, r)


def psi_fwdlap(params: dict, mcfg: ModelConfig, x, y, z, r):
    """Fused pass returning (Spatial(psi), E): psi, grad psi and lap psi in
    one forward traversal, for the separable family (the plain tensor path;
    the training path goes through
    ops.pallas_separable.psi_lap_train_separable). The symmetric family's
    psi and lap psi come from ops.pallas_train.psi_lap_train."""
    check_supported(params, mcfg)
    if "lam1" not in params:
        raise NotImplementedError(
            "psi_fwdlap covers the separable family; the symmetric family's "
            "(psi, lap psi) is ops.pallas_train.psi_lap_train")
    return _psi_separable_fwdlap(params, mcfg, x, y, z, r)
