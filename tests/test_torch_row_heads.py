"""The quotient's row entry (``ops/routing.psi_lap_rows``) on the CPU,
through the kernels' plain versions.

- On an (n_r, n_pts) batch it equals the flat ``routing.psi_lap`` on the
  batch's R expanded to every point, and ``quotient_loss`` through it equals
  the flat composition (the R-only heads at every point) in value and in
  the gradient of every parameter leaf: the separable family, the
  symmetric family with alpha(R) and GZ b(R), and the plain symmetric
  family, each gerade and ungerade; 1e-12 relative in float64, 1e-5 in
  float32 (gradients normwise, a leaf at most half the float32 flat
  composition's own error against float64 where that is larger).
- The models that no kernel carries (an excited separable state) still take
  the forward-Laplacian pass through ``variational._psi_hpsi_rows``, and no
  route counts a head evaluation for them.

torch runs on one thread (see test_torch_excited.py)."""

import dataclasses

import pytest
import torch

from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_separable as tps
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    routing as trt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    variational as tvar

from test_torch_excited import one_torch_thread, spy_on  # noqa: F401

FAMILIES = {
    "separable": dict(arch="separable"),
    "symmetric_gz_alpha": dict(gz=True, trainable_exponent=True),
    "symmetric": dict(),
}
RTOL = {"float64": 1e-12, "float32": 1e-5}


def model(family, p_sym, dtype, seed=2, **extra):
    """(Config, params): the family at H = 4 with every output layer and
    head drawn N(0, 0.3^2), so that each head shapes psi."""
    mcfg = tcfg.ModelConfig(hidden=4, hidden_e=8, hidden_gate=4,
                            inversion_symmetry=p_sym,
                            **FAMILIES[family], **extra)
    params = tans.init_params(mcfg, seed=seed, dtype=dtype, device="cpu")
    gen = torch.Generator().manual_seed(seed + 10)
    for name in ("lamout", "muout", "alpha2", "beta2", "gate2", "rnode2"):
        if name in params:
            w = params[name]["w"]
            params[name]["w"] = 0.3 * torch.randn(
                w.shape, generator=gen, dtype=torch.float64).to(w.dtype)
    return tcfg.Config(model=mcfg, dtype=dtype), params


def batch(cfg):
    """The polish's dual grid at three R: six rows, the first grid's
    padded with zero-weight points at coordinate 1."""
    return tvar.dual_grid_vbatch(cfg, 3, 6, 4, device="cpu")


def flat_rows(params, mcfg, x, y, z, r):
    """The flat composition that ``psi_lap_rows`` replaces: the heads at
    every point of the rows."""
    n_r, n_pts = x.shape
    rr = r[:, None].expand(n_r, n_pts).reshape(-1)
    psi, lap, _ = trt.psi_lap(params, mcfg, x.reshape(-1), y.reshape(-1),
                              z.reshape(-1), rr)
    return psi, lap


def loss_and_grads(params, cfg, vb):
    leaves = {(k, f): t.detach().clone().requires_grad_(True)
              for k, v in params.items() for f, t in v.items()}
    tree = {}
    for (k, f), t in leaves.items():
        tree.setdefault(k, {})[f] = t
    loss, aux = tvar.quotient_loss(tree, cfg, vb)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), aux["e_r"].detach(), {
        kf: torch.zeros_like(t) if g is None else g
        for (kf, t), g in zip(leaves.items(), grads)}


def grad_rtols(params, cfg, vb, want_grads):
    """Each leaf's limit on the gradients' normwise gap: RTOL in float64. In
    float32 the larger of RTOL and half the flat composition's own normwise
    error against float64: where a gradient's sum cancels, float32 rounds
    it by more than 1e-5 (the plain symmetric ungerade family's ``out/w``
    by ~4e-3 here), and the same sum in another order cannot agree with it
    more closely than its rounding."""
    if cfg.dtype == "float64":
        return {kf: RTOL["float64"] for kf in want_grads}
    p64 = {k: {f: t.double() for f, t in v.items()} for k, v in params.items()}
    vb64 = tvar.VBatch(*(t.double() for t in vb))
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    _, _, exact = loss_and_grads(p64, cfg64, vb64)
    return {kf: max(RTOL["float32"], 0.5 * float(
        (g.double() - exact[kf]).norm() / exact[kf].norm().clamp_min(1e-300)))
        for kf, g in want_grads.items()}


def assert_close(got, want, rtol, what):
    """Within ``rtol`` of ``want``'s largest magnitude, elementwise."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * max(scale, 1e-300), msg=what)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("p_sym", [1, -1])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_rows_equal_the_flat_composition(family, p_sym, dtype, monkeypatch):
    cfg, params = model(family, p_sym, dtype)
    vb = batch(cfg)
    rtol = RTOL[dtype]
    assert trt.kernel_of(params, cfg.model) == (
        "K1" if family == "separable" else "K2")
    before = dict(trt.head_evals)
    with torch.no_grad():
        psi, lap = trt.psi_lap_rows(params, cfg.model, vb.x, vb.y, vb.z,
                                    vb.r)
    assert trt.head_evals == {"rows": before["rows"] + vb.r.numel(),
                              "points": before["points"]}
    want_psi, want_lap = flat_rows(params, cfg.model, vb.x, vb.y, vb.z,
                                   vb.r)
    assert psi.shape == (vb.x.numel(),) and psi.dtype == vb.x.dtype
    assert_close(psi, want_psi, rtol, "psi")
    assert_close(lap, want_lap, rtol, "lap")
    loss, e_r, grads = loss_and_grads(params, cfg, vb)
    monkeypatch.setattr(trt, "psi_lap_rows", flat_rows)
    want_loss, want_e_r, want_grads = loss_and_grads(params, cfg, vb)
    assert_close(loss, want_loss, rtol, "loss")
    assert_close(e_r, want_e_r, rtol, "e_r")
    assert grads.keys() == want_grads.keys()
    limits = grad_rtols(params, cfg, vb, want_grads)
    for kf, g in grads.items():
        gap = float((g - want_grads[kf]).norm())
        assert gap <= limits[kf] * float(want_grads[kf].norm()), kf
    # every head the kernel reads receives a gradient through the rows
    heads = ("alpha1", "beta1", "gate1") if family != "separable" else (
        "alpha1", "beta1")
    for name in heads:
        if name in params:
            assert bool(grads[(name, "w")].any()), name


def test_excited_separable_takes_the_forward_laplacian_pass(monkeypatch):
    """A radial-node state: K1 carries it (its factor epilogue), so the
    quotient's rows go through K1's kernel part with the heads, the node
    head among them, once a row, and no point through ansatz.psi_fwdlap:
    bit for bit K1's plain path with the rows' heads broadcast, and within
    1e-12 of the forward-Laplacian pass, the plain reference."""
    cfg, params = model("separable", 1, "float64", xi_node=True)
    assert trt.kernel_of(params, cfg.model) == "K1"
    vb = batch(cfg)
    calls = []
    spy_on(monkeypatch, tans, ["psi_fwdlap"], calls)
    spy_on(monkeypatch, trt, ["separable_psi_lap", "train_psi_lap",
                              "psi_lap_train_separable"], calls)
    before = dict(trt.head_evals)
    fw = dict(trt.fwdlap_points)
    psi, hpsi = tvar._psi_hpsi_rows(params, cfg, vb)
    assert calls == ["separable_psi_lap"]
    assert trt.head_evals == {"rows": before["rows"] + vb.r.numel(),
                              "points": before["points"]}
    assert trt.fwdlap_points == fw
    n_r, n_pts = vb.x.shape
    rr = vb.r[:, None].expand(n_r, n_pts).reshape(-1)
    flat = [t.reshape(-1) for t in (vb.x, vb.y, vb.z)]
    # bit for bit the plain K1 path with the rows' heads broadcast
    a, b, *nodes = (None if h is None else
                    h[:, None].expand(n_r, n_pts).reshape(-1)
                    for h in tps.separable_heads(params, cfg.model, vb.r))
    with torch.no_grad():
        k_psi, k_lap = tps.psi_lap_separable_plain(
            tps.kernel_weights(params, vb.x.dtype), a, b, *flat, rr,
            p_sym=cfg.model.inversion_symmetry,
            factors=tps.factors(params, cfg.model), nodes=tuple(nodes))
    k_psi, k_hpsi = tvar._hpsi(cfg, vb, k_psi, k_lap)
    assert torch.equal(psi, k_psi) and torch.equal(hpsi, k_hpsi)
    # and the forward-Laplacian pass, the plain reference
    s, _ = tans.psi_fwdlap(params, cfg.model, *flat, rr)
    want_psi, want_hpsi = tvar._hpsi(cfg, vb, s.v[..., 0], s.l[..., 0])
    assert_close(psi, want_psi, 1e-12, "psi")
    assert_close(hpsi, want_hpsi, 1e-12, "hpsi")
