"""The port's analysis suite against the JAX package: probes, forces, the
nested-autograd operators, vibrational levels, the numpy inference replica
and the paper figure set's data.

The weights are the shipped artifacts (flagship_separable.npz, flagship.npz,
ungerade_2psu.npz, excited_2ssg.npz, flagship_model.bin) through
``from_jax_params``, in float64 unless stated; points come from a numpy
seed. Tolerances:
- probes (psi and LCAO cubes at n = 16, axis cuts, head curves): rtol
  1e-12, with an absolute floor of 1e-14 of the largest magnitude (node
  factors and the ungerade sector put zeros in the cube); normalisation
  constants rtol 1e-12;
- forces: autograd of the E head rtol 1e-12 (float32: 1e-5, with a floor
  of 1e-6 of the largest: the total force crosses zero), central
  differences rtol 1e-9 with a floor of 1e-9 of the largest (float32: the
  difference of two float32 heads over 2e-4 cancels about four digits, so
  port and JAX differ by float32 roundoff of E / 1e-4, held to 2e-3
  absolute), Hellmann-Feynman on the Cartesian n = 16 grid (regularised
  and raw) and on the 24 x 24 spheroidal grid rtol 1e-10;
- the nested-autograd laplacian against the forward-Laplacian pass rtol
  1e-10 (floor 1e-12), dV/dR rtol 1e-13;
- vibrational levels equal to JAX's to 1e-12 Ha and to the three rovib
  goldens to 2e-9 Ha;
- numpy inference against the port's torch forward rtol 1e-12 (floor
  1e-15)."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.analysis import etab as jetab
from pinn_for_quantum_wavefunction_surfaces_tpu.analysis import \
    forces as jforces
from pinn_for_quantum_wavefunction_surfaces_tpu.analysis import \
    numpy_infer as jnpi
from pinn_for_quantum_wavefunction_surfaces_tpu.analysis import \
    probes as jprobes
from pinn_for_quantum_wavefunction_surfaces_tpu.analysis import \
    vibration as jvib
from pinn_for_quantum_wavefunction_surfaces_tpu.io import modelbin as jbin
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
from pinn_for_quantum_wavefunction_surfaces_tpu.ops import operators as jops
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    etab as tetab
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    forces as tforces
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    numpy_infer as tnpi
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    plots as tplots
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    probes as tprobes
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    vibration as tvib
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    operators as tops
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.utils import profiling

from test_torch_excited import one_torch_thread  # noqa: F401
from test_torch_separable import (ARTIFACTS, as_t, load_artifact,  # noqa: F401
                                  no_jax_cache_writes)

# artifact -> envelope parity; every family of the paper set's path: K1
# (separable), K2 (GZ + alpha, both sectors), the excited plain path
# (radial node, wide alpha) and K3 (the reference-parity model.bin)
MODELS = {"flagship_separable.npz": 1, "flagship.npz": 1,
          "ungerade_2psu.npz": -1, "excited_2ssg.npz": 1,
          "flagship_model.bin": 1}
N_CUBE = 16


def model(name, dtype="float64"):
    """(JAX Config, port Config, numpy params, port params on the CPU)."""
    p = MODELS[name]
    if name.endswith(".bin"):
        params = jbin.load_params(os.path.join(ARTIFACTS, name))
    else:
        params = load_artifact(name)
    params = {k: {f: np.asarray(a, dtype) for f, a in v.items()}
              for k, v in params.items()}
    jc = pqs.Config(dtype=dtype)
    jc = dataclasses.replace(jc, model=dataclasses.replace(
        jc.model, inversion_symmetry=p))
    tc = tcfg.Config(dtype=dtype)
    tc = tc.replace(model=dataclasses.replace(tc.model, inversion_symmetry=p))
    return jc, tc, params, tans.from_jax_params(params, device="cpu")


def close(got, want, rtol, floor=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * np.abs(want).max())


def test_family_keys_survive_from_jax_params():
    """The keys the suite dispatches on (``gate1`` in importance_curve,
    ``lam1`` in ansatz.psi, ``alpha1`` / ``beta1`` in exponent_figure)
    come through from_jax_params for all four families."""
    for name in MODELS:
        _, _, params, tp = model(name)
        assert sorted(tp) == sorted(params)
        for key in ("gate1", "lam1", "alpha1", "beta1", "rnode1", "xalpha1"):
            assert (key in tp) == (key in params), (name, key)
        assert tans.param_count(tp) == jans.param_count(params) > 0


@pytest.mark.parametrize("name", list(MODELS))
def test_probes_match_jax(name):
    jc, tc, params, tp = model(name)
    for ri in (1.0, 2.3):
        want = jprobes.psi3d(params, jc, ri, N_CUBE)
        got = tprobes.psi3d(tp, tc, ri, N_CUBE)
        close(got[0], want[0], 1e-14)
        close(got[1], want[1], 1e-12, 1e-14)
        close(got[2], want[2], 1e-12, 1e-14)
        close(tprobes.normalization(tp, tc, ri, N_CUBE),
              jprobes.normalization(params, jc, ri, N_CUBE), 1e-12)
    for fn in ("psi_cut_x", "psi_cut_x_norm"):
        want = getattr(jprobes, fn)(params, jc, 1.0, N_CUBE)
        got = getattr(tprobes, fn)(tp, tc, 1.0, N_CUBE)
        for g, w in zip(got, want):
            close(g, w, 1e-12, 1e-14)
    # a denser evaluation grid normalised on the standard one
    want = jprobes.psi3d_norm(params, jc, 1.5, N_CUBE, dense_n=N_CUBE + 3)
    got = tprobes.psi3d_norm(tp, tc, 1.5, N_CUBE, dense_n=N_CUBE + 3)
    for g, w in zip(got, want):
        close(g, w, 1e-12, 1e-14)
    r, curve, label = tprobes.importance_curve(tp, tc, n=50)
    rj, cj, lj = jprobes.importance_curve(params, jc, n=50)
    assert label == lj
    close(r, rj, 0)
    close(curve, cj, 1e-12, 1e-14)
    if "gate1" in params:
        close(tprobes.gate_curve(tp, tc, n=50)[1],
              jprobes.gate_curve(params, jc, n=50)[1], 1e-12)
    for total in (False, True):
        close(tprobes.energy_curve(tp, tc, n=50, total=total)[1],
              jprobes.energy_curve(params, jc, n=50, total=total)[1], 1e-12)


R_FORCES = np.linspace(0.4, 4.0, 13)


@pytest.mark.parametrize("name", list(MODELS))
def test_forces_match_jax(name):
    jc, tc, params, tp = model(name)
    for total in (False, True):
        close(tforces.denergy_dr_autograd(tp, R_FORCES, total=total),
              jforces.denergy_dr_autograd(params, R_FORCES, total=total),
              1e-12)
        close(tforces.denergy_dr_fd(tp, R_FORCES, total=total),
              jforces.denergy_dr_fd(params, R_FORCES, total=total),
              1e-9, 1e-9)
    close(tforces.denergy_dr_hf_spheroidal(tp, tc, 1.3, n_xi=24, n_eta=24),
          jforces.denergy_dr_hf_spheroidal(params, jc, 1.3, n_xi=24,
                                           n_eta=24), 1e-10)
    for regularized in (True, False):
        close(tforces.denergy_dr_hellmann_feynman(
                  tp, tc, 1.3, n=16, regularized=regularized),
              jforces.denergy_dr_hellmann_feynman(
                  params, jc, 1.3, n=16, regularized=regularized), 1e-10)


def test_cartesian_hf_off_axis_matches_jax():
    """Nuclei off the x-axis (ry, rz != 0): the Cartesian integral (the
    spheroidal path refuses them, as in the JAX package)."""
    jc, tc, params, tp = model("flagship.npz")
    jc = dataclasses.replace(jc, model=dataclasses.replace(
        jc.model, ry=0.3, rz=-0.2))
    tc = tc.replace(model=dataclasses.replace(tc.model, ry=0.3, rz=-0.2))
    for regularized in (True, False):
        close(tforces.denergy_dr_hellmann_feynman(
                  tp, tc, 1.1, n=16, total=False, regularized=regularized),
              jforces.denergy_dr_hellmann_feynman(
                  params, jc, 1.1, n=16, total=False,
                  regularized=regularized), 1e-10)
    with pytest.raises(NotImplementedError, match="on-axis"):
        tforces.denergy_dr_hf_spheroidal(tp, tc, 1.1)


def test_psi_at_the_nuclei_is_finite():
    """The spheroidal HF subtraction evaluates psi at (+-R, 0, 0), where r1
    or r2 is 0 (the separable psi has xi = 1, eta = +-1 there)."""
    for name in MODELS:
        for dtype in ("float64", "float32"):
            _, tc, _, tp = model(name, dtype)
            for ri in (0.2, 1.0, 4.0):
                for x in (ri, -ri):
                    t = torch.tensor([x, 0.0, 0.0, ri],
                                     dtype=getattr(torch, dtype))
                    v = tans.psi(tp, tc.model, t[0:1], t[1:2], t[2:3],
                                 t[3:4])[0]
                    assert torch.isfinite(v).all(), (name, dtype, ri, x)


@pytest.mark.parametrize("name", ["flagship_separable.npz",
                                  "flagship_model.bin"])
def test_float32_forces_match_jax(name):
    """float32 on both sides, as the JAX CLI runs without x64 (R given to
    JAX as float32: this suite turns x64 on)."""
    jc, tc, params, tp = model(name, "float32")
    r32 = R_FORCES.astype(np.float32)
    for total in (False, True):
        close(tforces.denergy_dr_autograd(tp, r32, total=total),
              jforces.denergy_dr_autograd(params, r32, total=total), 1e-5,
              1e-6)
        got = tforces.denergy_dr_fd(tp, r32, total=total)
        want = jforces.denergy_dr_fd(params, r32, total=total)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("name", ["flagship_separable.npz", "flagship.npz"])
def test_nested_autograd_laplacian(name):
    """operators.laplacian_fn and grad_and_laplacian_fn (forward over
    reverse through torch.func) against the forward-Laplacian pass and
    against the JAX package's laplacian_fn."""
    jc, tc, params, tp = model(name)
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-3.0, 3.0, (8, 3))
    ri = 1.3

    def f_t(v):
        return tans.psi(tp, tc.model, v[0], v[1], v[2],
                        torch.tensor(ri, dtype=torch.float64))[0]

    def f_j(v):
        return jans.psi(params, jc.model, v[0], v[1], v[2],
                        jnp.asarray(ri))[0]

    xt = torch.as_tensor(xyz)
    lap = torch.func.vmap(tops.laplacian_fn(f_t))(xt).numpy()
    val, grad, lap2 = torch.func.vmap(tops.grad_and_laplacian_fn(f_t))(xt)
    s, _ = tans.psi_fwdlap(tp, tc.model, *as_t(*xyz.T, np.full(8, ri)))
    close(lap, s.l[..., 0].numpy(), 1e-10, 1e-12)
    close(lap2.numpy(), lap, 1e-12)
    close(val.numpy(), s.v[..., 0].numpy(), 1e-12)
    close(grad.numpy(), s.g[..., 0].numpy(), 1e-10, 1e-12)
    close(lap, jax.jit(jax.vmap(jops.laplacian_fn(f_j)))(jnp.asarray(xyz)),
          1e-10,
          1e-12)


def test_potential_dR_matches_jax():
    rng = np.random.default_rng(4)
    x, y, z = (rng.uniform(-6, 6, 200) for _ in range(3))
    r = rng.uniform(0.2, 4.0, 200)
    for ry, rz in ((0.0, 0.0), (0.3, -0.2)):
        jm = pqs.ModelConfig(ry=ry, rz=rz)
        tm = tcfg.ModelConfig(ry=ry, rz=rz)
        close(tops.potential_dR(tm, *as_t(x, y, z, r)).numpy(),
              jops.potential_dR(jm, x, y, z, r), 1e-13)


EVALUATED = os.path.join(ARTIFACTS, "evaluated.npz")
ROVIB = (("rovib_1ssg.json", "1ssg", 4), ("rovib_2ppu_well.json", "2ppu", 3),
         ("rovib_3dsg_well.json", "3dsg", 4))


def test_levels_from_table_match_jax():
    tt, jt = tetab.load_table(EVALUATED), jetab.load_table(EVALUATED)
    for j in (0, 3):
        got = tvib.levels_from_table(tt, n_levels=4, j=j)
        want = jvib.levels_from_table(jt, n_levels=4, j=j)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert tvib.summarize(got, -0.5) == jvib.summarize(want, -0.5)
    for state in tvib.SEPARATED_ATOM_N:
        assert tvib.dissociation_asymptote(state) == \
            jvib.dissociation_asymptote(state)


@pytest.mark.parametrize("golden", ROVIB, ids=[g[0] for g in ROVIB])
def test_rovibrational_goldens(golden):
    name, state, n_v = golden
    with open(os.path.join(ARTIFACTS, name)) as fh:
        art = json.load(fh)
    src = os.path.join(ARTIFACTS, "..", art["source"])
    got = tvib.rovibrational_table(tetab.load_table(src), state, n_v=n_v,
                                   j_max=art["j_max"])
    np.testing.assert_allclose(np.asarray(got["levels_Ha"]),
                               np.asarray(art["levels_Ha"]), rtol=0,
                               atol=2e-9)
    assert got == jvib.rovibrational_table(jetab.load_table(src), state,
                                           n_v=n_v, j_max=art["j_max"])


def test_oracle_table_matches_jax():
    got = tvib.oracle_table("1ssg", n_knots=6)
    want = jvib.oracle_table("1ssg", n_knots=6)
    np.testing.assert_array_equal(got["R"], want["R"])
    np.testing.assert_allclose(got["E"], want["E"], rtol=1e-12)


def _numpy_cases():
    """(label, numpy params, port ModelConfig, numpy_infer keywords) of
    tests/test_numpy_infer.py's families (seeded symmetric and minimal
    inits, GZ + alpha in both sectors, the reference model.bin) and of the
    separable ones (flagship, the excited radial node with wide alpha, the
    legacy node, the pi sector)."""
    cases = []
    for arch in ("symmetric", "minimal"):
        jm = pqs.ModelConfig(arch=arch)
        p = jax.tree.map(np.asarray, jans.init_params(
            jax.random.PRNGKey(0), jm, jnp.float64))
        cases.append((arch, p, tcfg.ModelConfig(arch=arch),
                      dict(arch=arch)))
    for p_sym in (1, -1):
        jm = pqs.ModelConfig(inversion_symmetry=p_sym,
                             trainable_exponent=True, gz=True)
        p = jax.tree.map(np.asarray, jans.init_params(
            jax.random.PRNGKey(2), jm, jnp.float64))
        p["alpha2"]["w"] = p["alpha2"]["w"] + 0.3
        p["beta2"]["w"] = p["beta2"]["w"] + 0.2
        cases.append((f"gz{p_sym:+d}", p,
                      tcfg.ModelConfig(inversion_symmetry=p_sym),
                      dict(inversion_symmetry=p_sym)))
    cases.append(("model.bin", model("flagship_model.bin")[2],
                  tcfg.ModelConfig(), {}))
    for name in ("flagship_separable.npz", "excited_2ssg.npz",
                 "excited_2ssg_legacynode.npz"):
        cases.append((name, load_artifact(name),
                      tcfg.ModelConfig(arch="separable"), {}))
    cases.append(("pi_2ppu.npz", load_artifact("pi_2ppu.npz"),
                  tcfg.ModelConfig(arch="separable", m_abs=1),
                  dict(m_abs=1)))
    return cases


def test_numpy_infer_matches_port():
    rng = np.random.RandomState(0)
    x, y, z = (rng.uniform(-8, 8, 200) for _ in range(3))
    r = rng.uniform(0.3, 3.5, 200)
    for label, p, tm, kw in _numpy_cases():
        tp = tans.from_jax_params(p, device="cpu")
        psi_t, e_t = tans.psi(tp, tm, *as_t(x, y, z, r))
        psi_n = tnpi.psi(p, x, y, z, r, **kw)
        close(psi_n, psi_t.numpy(), 1e-12, 1e-15)
        np.testing.assert_array_equal(psi_n, jnpi.psi(p, x, y, z, r, **kw))
        rt = torch.as_tensor(r)
        close(tnpi.energy(p, r), e_t.numpy(), 1e-12)
        if "gate1" in p:
            close(tnpi.gate(p, r), tans.gate(tp, rt).numpy(), 1e-12)
        a = tnpi.orbital_exponent(p, r)
        close(a, tans.orbital_exponent(tp, rt).numpy(), 1e-12)
        p_sym = kw.get("inversion_symmetry", 1)
        close(tnpi.gz_exponent(p, r, p_sym, a),
              tans.gz_exponent(tp, rt, p_sym, torch.as_tensor(a)).numpy(),
              1e-12)


def test_numpy_constants_match_port_ansatz():
    assert tnpi._ALPHA_MID == tans._ALPHA_MID
    assert tnpi._ALPHA_HALF == tans._ALPHA_HALF
    assert tnpi._BETA_HALF == tans._BETA_HALF


def test_exponent_data_keys_like_jax():
    """exponent_figure's data: alpha(R), b(R) of the JAX package's heads;
    the xi0(R) line for the legacy ``node1`` key only (not ``rnode1``, as in
    the JAX package), the eta0 line for ``enode1``; none for fixed
    exponents."""
    tc = tcfg.Config(dtype="float64")
    assert tplots.exponent_data(model("flagship_model.bin")[3], tc) is None
    for name, keys in (("flagship.npz", []), ("excited_2ssg.npz", []),
                       ("excited_2ssg_legacynode.npz", ["xi0"])):
        p = load_artifact(name)
        d = tplots.exponent_data(tans.from_jax_params(p, device="cpu"), tc)
        assert sorted(d) == sorted(["r", "alpha", "b"] + keys)
        rj = jnp.asarray(d["r"])
        a = jans.orbital_exponent(p, rj)
        close(d["alpha"], a, 1e-12)
        close(d["b"], jans.gz_exponent(p, rj, 1, a), 1e-12)
        if keys:
            close(d["xi0"], jans.node_xi0(p, rj), 1e-12)


def test_paper_set_writes_every_name(tmp_path):
    """plots.paper_set on the CPU at the smoke sizes (uniform n_test 8
    surface, 2 Hellmann-Feynman points, 16^3 cubes): every name of
    PAPER_SET_NAMES, and the data it draws equal to the JAX package's."""
    jc, tc, params, tp = model("flagship.npz")
    tc = tc.replace(train=dataclasses.replace(tc.train, n_test=N_CUBE))
    history = {"Ltot": [3.0, 2.0, 1.0], "Lpde": [2.0, 1.5, 0.8],
               "Lbc": [1.0, 0.5, 0.2], "Energy": [-0.5, -0.55, -0.6]}
    data = tplots.paper_set_data(tp, tc, n_test=8, grid="uniform",
                                 hf_points=2)
    paths = tplots.paper_set(tp, tc, str(tmp_path), history=history,
                             data=data)
    assert [os.path.basename(p) for p in paths] == [
        "fig2.pdf", "fig3.pdf", "fig4.pdf", "fig_R1.pdf", "fig_R2.pdf",
        "fig_R3.pdf", "energy.png", "R1.png", "R2.png", "R1e.png",
        "R2e.png", "loss_figure.pdf"]
    assert sorted(os.listdir(tmp_path)) == sorted(tplots.PAPER_SET_NAMES)
    assert all(os.path.getsize(p) > 0 for p in paths)
    assert sorted(data["seconds"]) == ["drawing", "forces", "probes",
                                       "surface"]
    # the data against the JAX package's functions on the same inputs
    f = data["forces"]
    close(f["autograd"], jforces.denergy_dr_autograd(params, f["r"], True),
          1e-12)
    close(f["fd"], jforces.denergy_dr_fd(params, f["r"], total=True), 1e-9,
          1e-9)
    close(f["r_hf"], np.linspace(f["r"][0], f["r"][-1], 2), 0)
    close(f["hf"], [tforces.denergy_dr_hf_spheroidal(tp, tc, float(ri))
                    for ri in f["r_hf"]], 0)
    for ri in tplots.PAPER_CUT_RS:
        for g, w in zip(data["grid"]["cuts"][ri],
                        jprobes.psi_cut_x_norm(params, jc, ri, N_CUBE)):
            close(g, w, 1e-12, 1e-14)
        close(data["norms"][ri], jprobes.normalization(params, jc, ri,
                                                       N_CUBE), 1e-12)
    for ri in tplots.PAPER_RAW_CUT_RS:
        for g, w in zip(data["raw_cuts"][ri],
                        jprobes.psi_cut_x(params, jc, ri, N_CUBE)):
            close(g, w, 1e-12, 1e-14)
    for ri in tplots.PAPER_PLANE_RS:
        xg, yg, psi = data["planes"][ri]
        assert psi.shape == (100, 100)
        want, _ = jans.psi(params, jc.model, xg.ravel(), yg.ravel(),
                           np.zeros(10000), np.full(10000, ri))
        close(psi.ravel(), want, 1e-12)
    close(data["grid"]["e_net_curve"],
          jans.energy(params, jnp.asarray(data["grid"]["rr"])), 1e-12)


def test_figures_fail_clearly_without_matplotlib(monkeypatch, tmp_path):
    """On a host without matplotlib every figure's data still computes, and
    drawing raises MatplotlibMissing naming the package, writing nothing."""
    _, tc, _, tp = model("flagship_separable.npz")
    tc = tc.replace(train=dataclasses.replace(tc.train, n_test=8))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    assert not tplots.have_matplotlib()
    assert tplots.forces_data(tp, tc, np.linspace(1.0, 2.0, 3),
                              hf_points=1)["hf"].shape == (1,)
    with pytest.raises(tplots.MatplotlibMissing, match="matplotlib"):
        tplots.gate_figure(tp, tc, str(tmp_path / "gate.pdf"))
    with pytest.raises(tplots.MatplotlibMissing, match="matplotlib"):
        tplots.paper_set(tp, tc, str(tmp_path), n_test=8, grid="uniform")
    assert os.listdir(tmp_path) == []


def test_loss_figures(tmp_path):
    history = {"Ltot": [3.0, 1.0], "Lpde": [2.0, 0.8], "Lbc": [1.0, 0.2],
               "Energy": [-0.5, -0.6]}
    for fn, name in ((tplots.loss_figure, "loss.jpg"),
                     (tplots.loss_figure_pdf, "loss.pdf")):
        out = fn(history, str(tmp_path / name), 1)
        assert os.path.getsize(out) > 0


def test_profiling_helpers(tmp_path):
    """trace turns tracing on for its region and writes a Chrome trace
    holding annotate's span (``pinn.<name>``); the phase marks recorded
    there time each phase; outside it tracing is off again: no span, no
    marks."""
    assert not profiling.enabled()
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("probe-region", 1):
            with profiling.recording() as marks:
                profiling.mark("scale")
                x = torch.full((3,), 2.0) * 1.5
                profiling.mark("sum")
                x.sum()
    assert not profiling.enabled()
    with open(tmp_path / profiling.TRACE_NAME) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "pinn.probe-region" in names
    assert torch.equal(x, torch.full((3,), 3.0))
    ms = profiling.phase_ms(marks)
    assert set(ms) == {"scale", "sum"} and min(ms.values()) >= 0.0
    with profiling.recording() as off:
        profiling.mark("scale")
    assert off is None
