"""K1's excited-state factor epilogue on the CPU: the route of the separable
excited states (``routing.psi_lap_rows``, the quotients' entry, and
``routing.psi_lap``, the flat one) through K1's CPU path
(``SeparableKernel`` on ``_cuda.as_built``: the plain versions with
``factors``) against ``ansatz.psi_fwdlap`` and its autograd, in float64.

- psi and lap psi within 1e-12 of the largest |value| (the nodes put zeros
  among the points, so a pointwise relative tolerance is no test there);
- every weight's and head's gradient of a seeded linear functional of
  (psi, lap psi) within 1e-10 of its norm;
- no point through the forward-Laplacian route, the heads once a row;
- the ground family's route calls the plain versions exactly as before the
  epilogue (no factor keywords), bit for bit.

Cases: the 4f pi_u network (wide alpha, angular node, m 1), one and two
radial nodes, the legacy radial node (the shipped witness), m 2 and 3, an
ungerade case with every node, nuclei off the axis, and the shipped
pi_2ppu and pi_3ppu params. The kernels themselves run on the card only
(chip_smoke.py phase 25); its ptxas parser names each library's template
flags (PG, EX) here."""

import os

import pytest
import torch

from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import checkpoint
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_separable as tps
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    routing as trt

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "artifacts")
DT = torch.float64

# (model config fields, shipped artifact or None)
CASES = {
    "4fpiu": (dict(m_abs=1, wide_alpha=True, eta_node=True), None),
    "rnode": (dict(xi_node=True), None),
    "rnode_rnodeb": (dict(xi_node=True, xi_node2=True), None),
    "legacy_node": (dict(xi_node=True), "excited_2ssg_legacynode"),
    "m2": (dict(m_abs=2), None),
    "m3_eta_node": (dict(m_abs=3, eta_node=True), None),
    "ungerade_all": (dict(inversion_symmetry=-1, m_abs=1, xi_node=True,
                          xi_node2=True, eta_node=True), None),
    "offset_nuclei": (dict(m_abs=2, xi_node=True, eta_node=True, ry=0.3,
                           rz=-0.2), None),
    "pi_2ppu": (dict(m_abs=1), "pi_2ppu"),
    "pi_3ppu": (dict(m_abs=1), "pi_3ppu"),
}


def model(case):
    """(ModelConfig, float64 params): the family's init with the output
    layers of the correction and of every head drawn N(0, 0.3^2), so that
    every factor shapes psi; or the shipped artifact's params."""
    fields, art = CASES[case]
    mcfg = tcfg.ModelConfig(arch="separable", hidden=16 if art else 8,
                            **fields)
    if art:
        tree, _ = checkpoint.load_params(os.path.join(ARTIFACTS,
                                                      art + ".npz"))
        return mcfg, tans.from_jax_params(tree.get("params", tree),
                                          dtype=DT, device="cpu")
    params = tans.init_params(mcfg, seed=5, dtype=DT, device="cpu")
    gen = torch.Generator().manual_seed(15)
    for name in ("lamout", "muout", "alpha2", "xalpha2", "beta2", "rnode2",
                 "rnodeb2", "enode2"):
        if name in params:
            params[name]["w"] = 0.3 * torch.randn(
                params[name]["w"].shape, generator=gen, dtype=DT)
    return mcfg, params


def rows(n_r=3, n_pts=40, seed=0):
    """(x, y, z) of n_r rows of n_pts points and the rows' R."""
    gen = torch.Generator().manual_seed(seed)
    x, y, z = (6.0 * torch.rand(n_r, n_pts, generator=gen, dtype=DT) - 3.0
               for _ in range(3))
    return x, y, z, torch.linspace(0.4, 3.0, n_r, dtype=DT)


def leaves(params):
    return {k: {f: t.detach().clone().requires_grad_(True)
                for f, t in v.items()} for k, v in params.items()}


def grads_of(params, psi, lap, wp, wl):
    """{(leaf, field): gradient} of sum(wp psi + wl lap psi); None where the
    functional does not reach the leaf (the E(R) head)."""
    flat = [(k, f) for k in params for f in params[k]]
    got = torch.autograd.grad((wp * psi + wl * lap).sum(),
                              [params[k][f] for k, f in flat],
                              allow_unused=True)
    return dict(zip(flat, got))


def gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("entry", ["psi_lap_rows", "psi_lap"])
@pytest.mark.parametrize("case", list(CASES))
def test_k1_factors_match_the_forward_laplacian_pass(case, entry):
    mcfg, params = model(case)
    assert tps.factors(params, mcfg) != tps.NO_FACTORS
    assert trt.kernel_of(params, mcfg) == "K1"
    x, y, z, r = rows()
    n_r, n_pts = x.shape
    r_pts = r[:, None].expand(n_r, n_pts).reshape(-1)
    gen = torch.Generator().manual_seed(1)
    wp, wl = (torch.randn(n_r * n_pts, generator=gen, dtype=DT)
              for _ in range(2))
    fw, heads = dict(trt.fwdlap_points), dict(trt.head_evals)
    p_k = leaves(params)
    if entry == "psi_lap_rows":
        psi, lap = trt.psi_lap_rows(p_k, mcfg, x, y, z, r)
        assert trt.head_evals == {"rows": heads["rows"] + n_r,
                                  "points": heads["points"]}
    else:
        psi, lap, _ = trt.psi_lap(p_k, mcfg, x.reshape(-1), y.reshape(-1),
                                  z.reshape(-1), r_pts)
        assert trt.head_evals == {"rows": heads["rows"],
                                  "points": heads["points"] + n_r * n_pts}
    assert trt.fwdlap_points == fw
    p_f = leaves(params)
    s, _ = tans.psi_fwdlap(p_f, mcfg, x.reshape(-1), y.reshape(-1),
                           z.reshape(-1), r_pts)
    want_psi, want_lap = s.v[..., 0], s.l[..., 0]
    assert gap(psi.detach(), want_psi.detach()) <= 1e-12
    assert gap(lap.detach(), want_lap.detach()) <= 1e-12
    got = grads_of(p_k, psi, lap, wp, wl)
    want = grads_of(p_f, want_psi, want_lap, wp, wl)
    for kf, g in want.items():
        if g is None:
            assert got[kf] is None or not bool(got[kf].any()), kf
            continue
        assert float((got[kf] - g).norm()) <= 1e-10 * float(g.norm()), kf
    # every node head the params have receives a gradient through the rows
    for name in ("node1", "rnode1", "rnodeb1", "enode1"):
        if name in params:
            assert bool(got[(name, "w")].any()), name


def test_ground_route_is_the_factor_free_plain_path():
    """Ground params take K1 without the epilogue: the route's psi, lap psi
    and cotangents equal, bit for bit, the plain versions called as the
    ground route called them before the epilogue existed (no factor
    keywords)."""
    mcfg = tcfg.ModelConfig(arch="separable", hidden=8)
    params = tans.init_params(mcfg, seed=2, dtype=DT, device="cpu")
    params["lamout"]["w"] = 0.3 * torch.ones_like(params["lamout"]["w"])
    params["muout"]["w"] = -0.2 * torch.ones_like(params["muout"]["w"])
    assert tps.factors(params, mcfg) == tps.NO_FACTORS
    x, y, z, r = (t.reshape(-1) if t.dim() > 1 else t for t in rows(1, 64))
    r = r.expand_as(x).contiguous()
    a, b = (h.detach() for h in tps.separable_heads(params, mcfg, r))
    ws = tps.kernel_weights(params, DT)
    kw = dict(p_sym=mcfg.inversion_symmetry, ry=mcfg.ry, rz=mcfg.rz)
    want_psi, want_lap = tps.psi_lap_separable_plain(ws, a, b, x, y, z, r,
                                                     **kw)
    a_g, b_g = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    ws_g = [w.clone().requires_grad_(True) for w in ws]
    cfg = (mcfg.inversion_symmetry, mcfg.ry, mcfg.rz, False, tps.NO_FACTORS)
    psi, lap = tps.SeparableKernel.apply(cfg, a_g, b_g, None, None, None, x,
                                         y, z, r, *ws_g)
    assert torch.equal(psi, want_psi) and torch.equal(lap, want_lap)
    gen = torch.Generator().manual_seed(3)
    dpsi, dlap = (torch.randn(x.numel(), generator=gen, dtype=DT)
                  for _ in range(2))
    got = torch.autograd.grad((psi, lap), ws_g + [a_g, b_g], (dpsi, dlap))
    dws, da, db = tps.psi_lap_separable_vjp_plain(ws, a, b, x, y, z, r, dpsi,
                                                  dlap, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, list(dws) + [da, db]))


def test_point_gradients_with_factors_are_refused():
    """No recipe takes the point gradients of an excited state: the K1
    wrapper refuses them on every device, with the route to take."""
    mcfg, params = model("4fpiu")
    x = torch.ones(8, dtype=DT)
    with pytest.raises(NotImplementedError, match="psi_fwdlap"):
        tps.psi_lap_train_separable(params, mcfg, x, x, x, x,
                                    point_grads=True)


@pytest.mark.parametrize("name, flags, want", [
    ("separable_fwd", "Lb1E", (False, True)),
    ("separable_fwd", "Lb0E", (False, False)),
    ("separable_bwd", "Lb0ELb1E", (False, True)),
    ("separable_bwd", "Lb1ELb0E", (True, False)),
    ("train_bwd", "Lb1E", (True, False)),
])
def test_ptxas_entries_read_each_librarys_flags(name, flags, want):
    """chip_smoke.py's ptxas parser reads a kernel's bool template
    parameters by its library's flag names: K1-fwd's one is EX, K1-bwd's
    two are PG then EX, K2-bwd's one is PG."""
    import chip_smoke
    log = (f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120"
           f"{name}_kernelIdLi16E{flags}dEEvPKT_' for 'sm_90a'\n"
           "    24 bytes stack frame, 24 bytes spill stores, 24 bytes spill "
           "loads\n"
           "ptxas info    : Used 80 registers, used 1 barriers\n")
    (entry,) = chip_smoke.ptxas_entries(name, log)
    assert (entry["dtype"], entry["h"], entry["pg"], entry["ex"],
            entry["registers"], entry["spill_stores"]) \
        == ("float64", 16) + want + (80, 24)
