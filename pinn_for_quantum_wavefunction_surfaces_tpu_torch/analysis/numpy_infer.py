"""Pure-numpy inference replica: psi and E(R) with no torch.

The port's copy of the JAX package's ``analysis/numpy_infer.py``.

Parity counterpart of the reference's torch-free readers (reference
``energy.py:22-35``, ``plot.py:20-57``), which exist to prove the model is
fully specified by its weight arrays alone. Works with params loaded from
any of the three checkpoint formats (npz / model.bin / .pt) and both
architectures.
"""

from __future__ import annotations

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def energy(params: dict, r: np.ndarray) -> np.ndarray:
    """E(R) eigenvalue head, numpy only (reference energy.py:31-33)."""
    r = np.asarray(r, np.float64)[..., None]
    e = _sigmoid(r @ params["e1"]["w"] + params["e1"]["b"])
    e = _sigmoid(e @ params["e2"]["w"] + params["e2"]["b"])
    return (e @ params["eout"]["w"] + params["eout"]["b"])[..., 0]


def gate(params: dict, r: np.ndarray) -> np.ndarray:
    r = np.asarray(r, np.float64)[..., None]
    g = _sigmoid(r @ params["gate1"]["w"] + params["gate1"]["b"])
    return (g @ params["gate2"]["w"] + params["gate2"]["b"])[..., 0]


# Bounded-head constants — MUST equal models/ansatz.py's (_ALPHA_MID,
# _ALPHA_HALF, _BETA_HALF); tests/test_torch_analysis.py cross-checks them.
_ALPHA_MID, _ALPHA_HALF = 1.5, 0.75
_BETA_HALF = 0.75


def orbital_exponent(params: dict, r: np.ndarray) -> np.ndarray:
    """alpha(R) = 1.5 + 0.75 tanh(head(R)); 1 when the head is absent.
    Wide-range variant 1.275 + 0.975 tanh(head) for "xalpha*" params
    (models/ansatz, ModelConfig.wide_alpha)."""
    r = np.asarray(r, np.float64)
    if "xalpha1" in params:
        a = _sigmoid(r[..., None] @ params["xalpha1"]["w"]
                     + params["xalpha1"]["b"])
        h = (a @ params["xalpha2"]["w"] + params["xalpha2"]["b"])[..., 0]
        return 1.275 + 0.975 * np.tanh(h)
    if "alpha1" not in params:
        return np.ones_like(r)
    a = _sigmoid(r[..., None] @ params["alpha1"]["w"] + params["alpha1"]["b"])
    h = (a @ params["alpha2"]["w"] + params["alpha2"]["b"])[..., 0]
    return _ALPHA_MID + _ALPHA_HALF * np.tanh(h)


def gz_exponent(params: dict, r: np.ndarray, p_sym: int = 1,
                alpha=None) -> np.ndarray:
    """Second Guillemin-Zener exponent b(R); 0 means pure LCAO.
    Mirrors models/ansatz.gz_exponent (incl. the ungerade b < alpha bound)."""
    r = np.asarray(r, np.float64)
    if "beta1" not in params:
        return np.zeros_like(r)
    a_ = _sigmoid(r[..., None] @ params["beta1"]["w"] + params["beta1"]["b"])
    h = (a_ @ params["beta2"]["w"] + params["beta2"]["b"])[..., 0]
    if p_sym >= 0:
        return _BETA_HALF * (1.0 + np.tanh(h))
    alpha = np.ones_like(r) if alpha is None else alpha
    return (alpha - 0.25) * 0.5 * (1.0 + np.tanh(h))


def psi(params: dict, x, y, z, r, arch: str = "symmetric",
        inversion_symmetry: int = 1, ry: float = 0.0,
        rz: float = 0.0, m_abs: int = 0) -> np.ndarray:
    """Full ansatz forward, numpy only (reference plot.py:36-49 for the
    minimal architecture; the symmetric branch mirrors models/ansatz.psi,
    including the trainable-exponent / Guillemin-Zener heads and the
    gerade-only output bias)."""
    x, y, z, r = (np.asarray(a, np.float64) for a in (x, y, z, r))
    p = inversion_symmetry
    alpha = orbital_exponent(params, r) \
        if ("alpha1" in params or "xalpha1" in params) else None

    if "lam1" in params:
        # separable-spheroidal family (models/ansatz._psi_separable):
        # psi = Phi_GZ * exp(l(t, R/4) + m(eta^2, R/4))
        r1 = np.sqrt((x - r) ** 2 + (y - ry) ** 2 + (z - rz) ** 2)
        r2 = np.sqrt((x + r) ** 2 + (y + ry) ** 2 + (z + rz) ** 2)
        bt = gz_exponent(params, r, p, alpha)
        phi = (np.exp(-alpha * r1 - bt * r2)
               + p * np.exp(-alpha * r2 - bt * r1))
        t = np.exp(r - 0.5 * (r1 + r2))
        eta2 = (0.5 * (r1 - r2) / r) ** 2
        rf = 0.25 * r * np.ones_like(t)

        def mlp_tanh(feats, l1, l2, l3):
            h = np.tanh(feats @ params[l1]["w"] + params[l1]["b"])
            h = np.tanh(h @ params[l2]["w"] + params[l2]["b"])
            return h @ params[l3]["w"] + params[l3]["b"]

        lam = mlp_tanh(np.stack([t, rf], -1), "lam1", "lam2", "lamout")
        mu = mlp_tanh(np.stack([eta2, rf], -1), "mu1", "mu2", "muout")
        cap = 3.0  # models/ansatz.LOG_CORR_CAP
        out = phi * np.exp(cap * np.tanh((lam[..., 0] + mu[..., 0]) / cap))
        if "node1" in params:
            # legacy radial node factor (models/ansatz.node_xi0)
            a = _sigmoid(r[..., None] @ params["node1"]["w"]
                         + params["node1"]["b"])
            h = (a @ params["node2"]["w"] + params["node2"]["b"])[..., 0]
            xi0 = 1.0 + 8.0 * _sigmoid(h)  # models/ansatz.XI0_CAP
            out = out * (0.5 * (r1 + r2) - r * xi0)
        if "rnode1" in params:
            # R-aware radial node: physical radius r + 12 sigmoid(head)
            a = _sigmoid(r[..., None] @ params["rnode1"]["w"]
                         + params["rnode1"]["b"])
            h = (a @ params["rnode2"]["w"] + params["rnode2"]["b"])[..., 0]
            p_node = r + 12.0 * _sigmoid(h)  # ansatz.RNODE_CAP
            out = out * (0.5 * (r1 + r2) - p_node)
            if "rnodeb1" in params:
                # second radial node: first node's radius + bounded gap
                # (models/ansatz.node_gap2: 0.3 + 8 sigmoid(head))
                a = _sigmoid(r[..., None] @ params["rnodeb1"]["w"]
                             + params["rnodeb1"]["b"])
                h = (a @ params["rnodeb2"]["w"]
                     + params["rnodeb2"]["b"])[..., 0]
                out = out * (0.5 * (r1 + r2)
                             - (p_node + 0.3 + 8.0 * _sigmoid(h)))
        if "enode1" in params:
            # angular node factor (models/ansatz.node_eta0sq)
            a = _sigmoid(r[..., None] @ params["enode1"]["w"]
                         + params["enode1"]["b"])
            h = (a @ params["enode2"]["w"] + params["enode2"]["b"])[..., 0]
            out = out * (eta2 - _sigmoid(h))
        if m_abs:
            # pi/delta sectors: harmonic transverse factor Re[(y+iz)^m]
            # (models/ansatz.transverse_harmonic)
            re, im = y, z
            for _ in range(m_abs - 1):
                re, im = re * y - im * z, re * z + im * y
            out = out * re
        return out

    def envelopes(xs):
        r1 = np.sqrt((xs - r) ** 2 + (y - ry) ** 2 + (z - rz) ** 2)
        r2 = np.sqrt((xs + r) ** 2 + (y + ry) ** 2 + (z + rz) ** 2)
        if alpha is None:
            return np.exp(-r1), np.exp(-r2)
        return np.exp(-alpha * r1), np.exp(-alpha * r2)

    # r_input models feed (f1, f2, R/4) — inferred from the weight shape,
    # mirroring ansatz.psi
    use_r = params["h1"]["w"].shape[0] == 3

    def base(f1, f2):
        feats = [f1, f2] + ([0.25 * r * np.ones_like(f1)] if use_r else [])
        h = np.stack(feats, axis=-1)
        h = _sigmoid(h @ params["h1"]["w"] + params["h1"]["b"])
        return _sigmoid(h @ params["h2"]["w"] + params["h2"]["b"])

    f1, f2 = envelopes(x)
    g = gate(params, r)
    if arch == "minimal":
        nn = (2.0 * base(f1, f2)) @ params["out"]["w"] + params["out"]["b"]
        return f1 + f2 + nn[..., 0] * g
    f1m, f2m = envelopes(-x)
    b = base(f1, f2) + p * base(f1m, f2m)
    nn = b @ params["out"]["w"]
    if p > 0:
        # the constant output bias is gerade-only (exact antisymmetry for
        # P=-1), matching models/ansatz.psi
        nn = nn + params["out"]["b"]
    if "beta1" in params:
        a_ = alpha if alpha is not None else np.ones_like(r)
        bt = gz_exponent(params, r, p, a_)
        r1 = np.sqrt((x - r) ** 2 + (y - ry) ** 2 + (z - rz) ** 2)
        r2 = np.sqrt((x + r) ** 2 + (y + ry) ** 2 + (z + rz) ** 2)
        n_lcao = (np.exp(-a_ * r1 - bt * r2)
                  + p * np.exp(-a_ * r2 - bt * r1))
    else:
        n_lcao = f1 + p * f2
    return nn[..., 0] * g + n_lcao
