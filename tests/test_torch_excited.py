"""Excited sigma states in the port against the JAX package: the radial and
angular node factors of the separable family (tests/test_excited.py's
families), their route through K1's factor epilogue, penalty deflation
against frozen references, the 17 shipped excited artifacts' goldens, and
``cli variational --deflate`` / ``cli evaluate --contam-vs``.

float64 throughout; params are the JAX package's init with its output
layers drawn from a numpy seed (as tests/test_excited.py's _node_params),
points are numpy-seeded. Tolerances:
- psi rtol 1e-12, grad psi and lap psi rtol 1e-10, each with an absolute
  floor of 1e-14 (psi) or 1e-12 (grad, lap) of the largest magnitude: the
  node factors put zeros inside the point cloud; E rtol 1e-14;
- the deflated loss and its aux rtol 1e-11, its gradients 1e-8 of each
  tensor's largest entry (tests/test_pallas_separable.py's gradient rtol);
  the reference stacks rtol 1e-10 (a ground reference goes through K1's
  plain version in the port and through fwdlap in JAX: K1's lap
  tolerance), the contamination curve rtol 1e-9;
- goldens: E_int rtol 1e-10 (the card's bound of phase 18);
- the polish: within 0.1 mHa of the exact state (the JAX test's bound)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu import cli as jcli
from pinn_for_quantum_wavefunction_surfaces_tpu.analysis import energy as jen
from pinn_for_quantum_wavefunction_surfaces_tpu.io import checkpoint as jckpt
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
from pinn_for_quantum_wavefunction_surfaces_tpu.training import \
    distill as jdistill
from pinn_for_quantum_wavefunction_surfaces_tpu.training import \
    losses as jlosses
from pinn_for_quantum_wavefunction_surfaces_tpu.training import \
    variational as jvar
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import cli
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    energy as ten
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    exact as texact
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_separable as tps
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    routing as trt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    distill as tdistill
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    variational as tvar

from test_torch_separable import (ARTIFACTS, as_t, jax_model,  # noqa: F401
                                  load_artifact, no_jax_cache_writes)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one thread while these modules run: the suite runs several
    workers side by side, and torch's thread pool in each of them, spinning
    against the others, made the polishes here take minutes instead of
    seconds. tests/test_torch_pi.py imports this fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def excited_model(p=1, seed=1, **factors):
    """(JAX ModelConfig, port ModelConfig, numpy params) of a separable
    family with the given factors (xi_node, xi_node2, eta_node, m_abs):
    the JAX init with the output layers of the correction and of every
    head drawn N(0, 0.3^2) from a numpy seed, so every factor shapes psi."""
    kw = dict(arch="separable", inversion_symmetry=p, **factors)
    mcfg = pqs.ModelConfig(**kw)
    params = jax.tree.map(np.asarray, jans.init_params(
        jax.random.PRNGKey(seed), mcfg, jnp.float64))
    rng = np.random.default_rng(seed + 10)
    for name in ("lamout", "muout", "alpha2", "beta2", "rnode2", "enode2",
                 "rnodeb2"):
        if name in params:
            params[name]["w"] = 0.3 * rng.standard_normal(
                params[name]["w"].shape)
    return mcfg, tcfg.ModelConfig(**kw), params


def points48(n=48, seed=0):
    rng = np.random.default_rng(seed)
    x, y, z = (rng.uniform(-5.0, 5.0, n) for _ in range(3))
    return x, y, z, rng.uniform(0.2, 4.0, n)


def close(got, want, rtol, floor):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * np.abs(want).max())


def assert_family_matches(mcfg, tm, params, pts):
    """psi (value path), and psi, grad psi, lap psi, E (fwdlap path)."""
    s, e = jans.psi_fwdlap(params, mcfg, *pts)
    pv, _ = jans.psi(params, mcfg, *pts)
    tp = tans.from_jax_params(params, device="cpu")
    st, et = tans.psi_fwdlap(tp, tm, *as_t(*pts))
    pt, _ = tans.psi(tp, tm, *as_t(*pts))
    close(pt.numpy(), pv, 1e-12, 1e-14)
    close(st.v[..., 0].numpy(), s.v[..., 0], 1e-12, 1e-14)
    close(st.g[..., 0].numpy(), s.g[..., 0], 1e-10, 1e-12)
    close(st.l[..., 0].numpy(), s.l[..., 0], 1e-10, 1e-12)
    np.testing.assert_allclose(et.numpy(), np.asarray(e), rtol=1e-14)


NODE_FAMILIES = {
    "rnode": dict(xi_node=True),
    "rnode_ungerade": dict(p=-1, xi_node=True),
    "xi_node2": dict(xi_node=True, xi_node2=True),
    "eta_node": dict(eta_node=True),
    "all_ungerade": dict(p=-1, xi_node=True, xi_node2=True, eta_node=True),
}


@pytest.mark.parametrize("family", list(NODE_FAMILIES))
def test_node_factors_match_jax(family):
    mcfg, tm, params = excited_model(**NODE_FAMILIES[family])
    assert_family_matches(mcfg, tm, params, points48())


def test_legacy_node_checkpoint_matches_jax():
    """The legacy "node*" params (fixed-cap xi0 formula) of the shipped
    witness artifact."""
    params = load_artifact("excited_2ssg_legacynode.npz")
    assert "node1" in params and "rnode1" not in params
    kw = dict(arch="separable", xi_node=True)
    assert_family_matches(pqs.ModelConfig(**kw), tcfg.ModelConfig(**kw),
                          params, points48(seed=2))
    r = np.array([0.2, 1.0, 4.0])
    np.testing.assert_allclose(
        tans.node_xi0(tans.from_jax_params(params, device="cpu"),
                      torch.as_tensor(r)).numpy(),
        np.asarray(jans.node_xi0(params, jnp.asarray(r))), rtol=1e-15)


def gz_at(params, x, y, z, r):
    """The GZ physics part of the port's heads (P = +1) and p_half, eta^2."""
    a = tans.orbital_exponent(params, r)
    b = tans.gz_exponent(params, r, 1, a)
    r1 = torch.sqrt((x - r) ** 2 + y ** 2 + z ** 2)
    r2 = torch.sqrt((x + r) ** 2 + y ** 2 + z ** 2)
    gz = torch.exp(-a * r1 - b * r2) + torch.exp(-a * r2 - b * r1)
    return gz, 0.5 * (r1 + r2), (0.5 * (r1 - r2) / r) ** 2


@pytest.mark.parametrize("factors", [dict(xi_node=True),
                                     dict(eta_node=True),
                                     dict(xi_node=True, xi_node2=True)])
def test_node_init_matches_jax(factors):
    """The port's init has the JAX init's keys, shapes and head biases, and
    its factors take the values of tests/test_excited.py's init tests:
    node at R + 2 bohr, eta0^2 = 1/3, the second node 2.5 bohr beyond."""
    for wide in (False, True):
        mcfg = pqs.ModelConfig(arch="separable", wide_alpha=wide, **factors)
        tm = tcfg.ModelConfig(arch="separable", wide_alpha=wide, **factors)
        jp = jans.init_params(jax.random.PRNGKey(0), mcfg, jnp.float64)
        tp = tans.init_params(tm, seed=0, dtype="float64", device="cpu")
        assert sorted(jp) == sorted(tp)
        for k in jp:
            for f in jp[k]:
                assert tuple(tp[k][f].shape) == jp[k][f].shape, (k, f)
        for k in ("rnode2", "enode2", "rnodeb2"):
            if k in jp:
                np.testing.assert_array_equal(tp[k]["b"].numpy(),
                                              np.asarray(jp[k]["b"]))
                assert not tp[k]["w"].any()
    x, y, z, r = as_t(*points48())
    psi, _ = tans.psi(tp, tm, x, y, z, r)
    gz, p_half, eta2 = gz_at(tp, x, y, z, r)
    want = gz
    if tm.xi_node:
        want = want * (p_half - (r + 2.0))
        np.testing.assert_allclose((tans.node_xi0(tp, r) * r).numpy(),
                                   (r + 2.0).numpy(), rtol=1e-12)
    if tm.xi_node2:
        want = want * (p_half - (r + 4.5))
        np.testing.assert_allclose(tans.node_gap2(tp, r).numpy(), 2.5,
                                   rtol=1e-12)
    if tm.eta_node:
        want = want * (eta2 - 1.0 / 3.0)
        np.testing.assert_allclose(tans.node_eta0sq(tp, r).numpy(),
                                   1.0 / 3.0, rtol=1e-12)
    np.testing.assert_allclose(psi.numpy(), want.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="requires"):
        tans.init_params(tcfg.ModelConfig(arch="separable", xi_node2=True),
                         seed=0, device="cpu")


def spy_on(monkeypatch, module, names, calls):
    for name in names:
        real = getattr(module, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(module, name, spy)


ROUTING_CASES = {
    "ground": dict(),
    "rnode": dict(xi_node=True),
    "eta_node": dict(eta_node=True),
    "m_abs": dict(m_abs=1),
}


@pytest.mark.parametrize("case", list(ROUTING_CASES))
def test_kernel_guard_and_routing(case, monkeypatch):
    """``routing.kernel_of`` gives every separable model to K1, which
    carries the node and transverse factors in its factor epilogue, where
    the JAX package's pallas_unsupported_reason (m_abs by the config, node
    factors by the params) keeps them off its Pallas kernel, a deliberate
    difference. routing.psi_lap_forward and reference_state_on_batch send
    every separable model
    to the K1 wrapper, quotient_loss and the deflated loss to its kernel
    part (the quotients' rows, the heads once a row), and none to
    psi_fwdlap; the values equal the forward-Laplacian pass's."""
    mcfg, tm, params = excited_model(hidden=4, **ROUTING_CASES[case])
    tp = tans.from_jax_params(params, device="cpu")
    jax_guarded = jlosses.pallas_unsupported_reason(params, mcfg) is not None
    assert jax_guarded == (case != "ground")
    assert trt.kernel_of(tp, tm) == trt.kernel_of(tp, tm, True) == "K1"
    x, y, z, r = as_t(*points48(8))
    calls = []
    spy_on(monkeypatch, tans, ["psi_fwdlap"], calls)
    spy_on(monkeypatch, trt, ["psi_lap_train_separable",
                              "separable_psi_lap"], calls)
    psi, lap = trt.psi_lap_forward(tp, tm, x, y, z, r)
    assert calls == ["psi_lap_train_separable"]
    assert psi.shape == lap.shape == x.shape
    calls.clear()
    s, _ = tans.psi_fwdlap(tp, tm, x, y, z, r)
    close(psi.numpy(), s.v[..., 0].numpy(), 1e-12, 1e-14)
    close(lap.numpy(), s.l[..., 0].numpy(), 1e-10, 1e-12)
    tc = tcfg.Config(model=tm, dtype="float64")
    vb = tvar.spheroidal_vbatch(tc, n_r=2, n_xi=6, n_eta=4, device="cpu")
    # the quotients' rows: K1 with its heads once a row
    calls.clear()
    tvar.quotient_loss(tp, tc, vb)
    assert calls == ["separable_psi_lap"]
    calls.clear()
    psi0, hpsi0 = tvar.reference_state_on_batch(tp, tc, vb)
    assert calls == ["psi_lap_train_separable"] and not psi0.requires_grad
    calls.clear()
    tvar.quotient_loss_deflated(tp, tc, vb, psi0, hpsi0)
    assert calls == ["separable_psi_lap"]


# the references of make excited-3ssg, in its order: k of them target the
# (k+1)-th gerade sigma state
REFERENCES = ("flagship_separable.npz", "excited_2ssg.npz",
              "excited_3dsg.npz")


def deflation_setup(k):
    """A 3ssg-family model (P = +1, two radial nodes, wide alpha), its
    first k references, and the dual-grid training batch at n_r = 1 (two
    rows: the 10 x 8 grid padded with zero-weight points at coordinate 1,
    and its coprime 27 x 21 partner) at R = 0.2, for both packages."""
    mcfg, tm, params = excited_model(seed=4, xi_node=True, xi_node2=True,
                                     wide_alpha=True)
    jc = pqs.Config(dtype="float64", model=mcfg)
    tc = tcfg.Config(dtype="float64", model=tm)
    vt = tvar.dual_grid_vbatch(tc, 1, 10, 8, device="cpu")
    vj = jvar.VBatch(*(jnp.asarray(a.numpy()) for a in vt))
    refs = [load_artifact(name) for name in REFERENCES[:k]]
    return jc, tc, params, vj, vt, refs


@pytest.mark.parametrize("k", [1, 2, 3])
def test_deflation_matches_jax(k):
    jc, tc, params, vj, vt, refs = deflation_setup(k)
    assert float(vt.w[0, -1]) == 0.0 and float(vt.x[0, -1]) == 1.0
    pj, hj = jvar.reference_states_on_batch(refs, jc, vj)
    pt, ht = tvar.reference_states_on_batch(
        [tans.from_jax_params(p, device="cpu") for p in refs], tc, vt)
    assert pt.shape == (k, 2, vt.x.shape[1])
    assert bool(torch.isfinite(pt).all() and torch.isfinite(ht).all())
    close(pt.numpy(), pj, 1e-10, 1e-12)
    close(ht.numpy(), hj, 1e-10, 1e-12)
    # the stack is row-orthogonal in the quadrature inner product
    for i in range(k):
        for j in range(i):
            cross = torch.sum(vt.w * pt[i] * pt[j], dim=1)
            norm = torch.sqrt(torch.sum(vt.w * pt[i] ** 2, dim=1)
                              * torch.sum(vt.w * pt[j] ** 2, dim=1))
            assert float((cross / norm).abs().max()) < 1e-10

    def jloss(p):
        return jvar.quotient_loss_deflated(p, jc, vj, pj, hj, 0.7)

    (lj, auxj), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tp = {n: {f: t.requires_grad_(True) for f, t in d.items()}
          for n, d in tans.from_jax_params(params, device="cpu").items()}
    lt, auxt = tvar.quotient_loss_deflated(tp, tc, vt, pt, ht, 0.7)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-11)
    assert sorted(auxt) == sorted(auxj)
    for name in auxj:
        np.testing.assert_allclose(auxt[name].detach().numpy(),
                                   np.asarray(auxj[name]), rtol=1e-11,
                                   err_msg=name)
    for n in gj:
        for f in gj[n]:
            want = np.asarray(gj[n][f])
            np.testing.assert_allclose(
                tp[n][f].grad.numpy(), want, rtol=0,
                atol=1e-8 * max(np.abs(want).max(), 1e-300),
                err_msg=f"{n}/{f}")


def test_contamination_curve_matches_jax():
    jc, tc, params, _, _, refs = deflation_setup(3)
    want = jvar.contamination_curve(params, refs, jc, [0.2, 1.0, 4.0],
                                    n_xi=16, n_eta=12)
    got = tvar.contamination_curve(tans.from_jax_params(params, device="cpu"),
                                   refs, tc, [0.2, 1.0, 4.0], n_xi=16,
                                   n_eta=12)
    assert got.shape == (3,) and np.all((got > 0) & (got < 1))
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_deflated_polish_converges_to_2ssg():
    """tests/test_excited.py::test_deflated_polish_converges_to_2ssg with
    its budget (n_xi = n_eta = 32, 120 Adam + 80 L-BFGS steps at fixed
    R = 1, psi0 the shipped flagship) from the port's seeded init: the
    second gerade eigenvalue within 0.1 mHa, the node inside the grid."""
    p0 = load_artifact("flagship_separable.npz")
    tc = tcfg.Config(model=tcfg.ModelConfig(arch="separable", xi_node=True),
                     domain=tcfg.DomainConfig(fixed_r=1.0), dtype="float64")
    init = tans.init_params(tc.model, seed=0, dtype="float64", device="cpu")
    out = tvar.polish_spheroidal(init, tc, n_xi=32, n_eta=32, steps=80,
                                 adam_steps=120, deflate_params=p0,
                                 device="cpu")
    vb = tvar.spheroidal_vbatch(tc, n_xi=64, n_eta=64, device="cpu")
    with torch.no_grad():
        _, aux = tvar.quotient_loss(out, tc, vb, 0.0)
        xi0 = float(tans.node_xi0(out, torch.tensor([1.0],
                                                    dtype=torch.float64)))
    e = float(aux["e_r"][0])
    e2 = texact.exact_electronic_energy(1.0, "2ssg")
    assert abs(e - e2) < 1e-4, (e, e2)
    assert 1.2 < xi0 < 5.0, xi0


def excited_configs(name):
    """Numpy params and (JAX, port) configs of a shipped excited artifact,
    derived from its meta as cli evaluate and chip_smoke.py phase 18 do."""
    tree, meta = jckpt.load_params(os.path.join(ARTIFACTS, name + ".npz"))
    model, domain = chip_smoke.excited_fields(meta)
    jc = pqs.Config(dtype="float64", model=pqs.ModelConfig(**model),
                    domain=pqs.DomainConfig(**domain))
    tc = tcfg.Config(dtype="float64", model=tcfg.ModelConfig(**model),
                     domain=tcfg.DomainConfig(**domain))
    return load_artifact(name + ".npz"), jc, tc


@pytest.mark.parametrize("name", list(chip_smoke.EXCITED_BANDS))
def test_excited_artifact_goldens(name):
    """E_int (spheroidal 96 x 96) at the two ends of the artifact's own R
    domain: chip_smoke.py's constants are the JAX package's values
    (recomputed here), and the port reproduces them to 1e-10."""
    params, jc, tc = excited_configs(name)
    tp = tans.from_jax_params(params, device="cpu")
    probes = chip_smoke.EXCITED_PROBE_R.get(name, chip_smoke.STANDARD_PROBE_R)
    gold = chip_smoke.JAX_EINT_EXCITED[name]
    assert (probes[0], probes[-1]) == (tc.domain.r_lo, tc.domain.r_hi)
    for i in (0, -1):
        want = jen.rayleigh_quotient_spheroidal(params, jc, probes[i])
        np.testing.assert_allclose(gold[i], want, rtol=1e-13)
        got = ten.rayleigh_quotient_spheroidal(tp, tc, probes[i])
        np.testing.assert_allclose(got, want, rtol=1e-10)


def fake_polish(params, cfg, **kw):
    """The JAX polish stood in for by the seeded init: the meta of the JAX
    CLI does not depend on the polish."""
    return jax.tree.map(np.asarray, jans.init_params(
        jax.random.PRNGKey(0), cfg.model, jnp.float64))


SMOKE = ["--spheroidal", "--adam-warmup", "2", "--lbfgs", "2", "--n-r", "2",
         "--n-xi", "8", "--n-eta", "6", "--dtype", "float64"]
FLAGSHIP = os.path.join(ARTIFACTS, "flagship_separable.npz")
VARIATIONAL_CASES = {
    "2ssg": ["--xi-node", "--deflate", FLAGSHIP],
    "3dsg_override": ["--eta-node", "--wide-alpha", "--deflate", FLAGSHIP,
                      "--deflate", os.path.join(ARTIFACTS,
                                                "excited_2ssg.npz"),
                      "--target-state", "3ssg"],
}


@pytest.mark.parametrize("case", list(VARIATIONAL_CASES))
def test_cli_variational_deflate_meta_matches_jax(case, tmp_path, capsys,
                                                  monkeypatch):
    """``cli variational --deflate`` writes the JAX CLI's meta for the same
    flags (deflated, target_state from the sector count or the override)
    and its JSON line, with "deflated" true; the params' layout is JAX's."""
    flags = ["--arch", "separable"] + VARIATIONAL_CASES[case] + SMOKE
    monkeypatch.setattr(jvar, "polish_spheroidal", fake_polish)
    jcli.main(["variational", "--out", str(tmp_path / "j")] + flags)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cli.main(["variational", "--out", str(tmp_path / "t"), "--device",
              "cpu"] + flags)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.pop("device") == "cpu"
    assert got.pop("out") != want.pop("out")
    assert got == want and got["deflated"] is True
    jt, jm = jckpt.load_params(str(tmp_path / "j" / "variational.npz"))
    tt, tm = jckpt.load_params(str(tmp_path / "t" / "variational.npz"))
    assert tm == jm and "deflated" in tm
    assert sorted(tt["params"]) == sorted(jt["params"])


def test_cli_evaluate_contam_vs_matches_jax(tmp_path, capsys, monkeypatch):
    """``cli evaluate --contam-vs`` prints the JAX CLI's keys, with the
    same int_* and contamination values (the fit stood in for on both
    sides: these fields read psi only)."""
    src = os.path.join(ARTIFACTS, "excited_2ssg.npz")
    flags = ["--dtype", "float64", "--table-knots", "0", "--r-lo", "1.0",
             "--r-hi", "1.1", "--target-state", "2ssg", "--contam-vs",
             FLAGSHIP]
    monkeypatch.setattr(jdistill, "distill",
                        lambda params, cfg, n, steps: (params,
                                                       {"fit_rms": 0.0}))
    monkeypatch.setattr(tdistill, "distill",
                        lambda params, cfg, n, steps: (
                            params, {"fit_rms": 0.0, "seconds": {}}))
    jcli.main(["evaluate", src, "--out", str(tmp_path / "j")] + flags)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cli.main(["evaluate", src, "--out", str(tmp_path / "t"), "--device",
              "cpu"] + flags)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    assert want["contam_max_frac"] < 1e-4
    for key in ("int_mean_err_mHa", "int_max_err_mHa",
                "int_min_signed_mHa"):
        assert got[key] == want[key], key
    for key in ("contam_max_frac", "contam_mean_frac"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9)


def test_phase18_evaluate_constants_are_jax_contamination():
    """chip_smoke.py's JAX_EVAL_2SSG contamination fields are the JAX
    package's contamination curve of the shipped 2ssg against the flagship
    on cli evaluate's 39 R (the fit does not enter them)."""
    params, jc, _ = excited_configs("excited_2ssg")
    r = np.round(np.arange(0.2, 4.0 + 0.1, 0.1), 2)
    frac = jvar.contamination_curve(params, [load_artifact(
        "flagship_separable.npz")], jc, r)
    np.testing.assert_allclose(
        (frac.max(), frac.mean()),
        (chip_smoke.JAX_EVAL_2SSG["contam_max_frac"],
         chip_smoke.JAX_EVAL_2SSG["contam_mean_frac"]), rtol=1e-12)
