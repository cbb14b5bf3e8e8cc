"""Spheroidal scoring and the exact oracle through the PyTorch port.

The flagship E_int golden of tests/test_separable.py:99-124 (within
[-1e-4, 0.01] mHa of the exact ODE oracle at R = 0.2, 1, 2, 4) and the
ungerade one (:127-153), scored by the port's Rayleigh quotient, whose psi
and lap psi come from the fused kernel module's forward. The quotients also
agree with the JAX package's to rtol 1e-12 (float64)."""

import numpy as np
import pytest

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.analysis import \
    energy as jen
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    energy as ten
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    exact as texact
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans

from test_torch_separable import load_artifact, no_jax_cache_writes  # noqa: F401


def test_flagship_artifact_golden():
    params = tans.from_jax_params(load_artifact("flagship_separable.npz"),
                                  device="cpu")
    cfg = tcfg.Config(dtype="float64",
                      model=tcfg.ModelConfig(arch="separable"))
    r_probe = np.array([0.2, 1.0, 2.0, 4.0])
    exact = ten.exact_energy_ode(r_probe)
    for ri, ex in zip(r_probe, exact):
        e = ten.rayleigh_quotient_spheroidal(params, cfg, float(ri))
        err_mha = 1e3 * (e - ex)
        assert -1e-4 <= err_mha <= 0.01, (ri, err_mha)


def test_ungerade_artifact_golden():
    params = tans.from_jax_params(load_artifact("ungerade_separable.npz"),
                                  device="cpu")
    cfg = tcfg.Config(dtype="float64", model=tcfg.ModelConfig(
        arch="separable", inversion_symmetry=-1))
    r_probe = np.array([1.0, 2.0])
    exact = ten.exact_energy_ode(r_probe, state="2psu")
    for ri, ex in zip(r_probe, exact):
        e = ten.rayleigh_quotient_spheroidal(params, cfg, float(ri))
        err_mha = 1e3 * (e - ex)
        assert -1e-4 <= err_mha <= 0.005, (ri, err_mha)


@pytest.mark.parametrize("ri", [0.5, 2.5])
def test_quotient_matches_jax(ri):
    np_params = load_artifact("flagship_separable.npz")
    jcfg = pqs.Config(dtype="float64",
                      model=pqs.ModelConfig(arch="separable"))
    tc = tcfg.Config(dtype="float64",
                     model=tcfg.ModelConfig(arch="separable"))
    e_j = jen.rayleigh_quotient_spheroidal(np_params, jcfg, ri, n_xi=48,
                                           n_eta=40)
    e_t = ten.rayleigh_quotient_spheroidal(
        tans.from_jax_params(np_params, device="cpu"), tc, ri, n_xi=48,
        n_eta=40)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-12)


def test_symmetric_quotient_matches_jax():
    """The symmetric flagship (GZ + alpha) scored through the K2 module's
    forward equals the JAX quotient to 1e-10 and lies above the exact
    level."""
    np_params = load_artifact("flagship.npz")
    kw = dict(gz=True, trainable_exponent=True)
    e_j = jen.rayleigh_quotient_spheroidal(
        np_params, pqs.Config(dtype="float64", model=pqs.ModelConfig(**kw)),
        1.0, n_xi=48, n_eta=40)
    e_t = ten.rayleigh_quotient_spheroidal(
        tans.from_jax_params(np_params, device="cpu"),
        tcfg.Config(dtype="float64", model=tcfg.ModelConfig(**kw)), 1.0,
        n_xi=48, n_eta=40)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-10)
    assert e_t > ten.exact_energy_ode([1.0])[0]


def test_grid_and_oracle_match_jax():
    for c, n_xi, n_eta in ((0.2, 12, 8), (3.0, 40, 24)):
        for a, b in zip(ten.spheroidal_grid(c, n_xi, n_eta),
                        jen.spheroidal_grid(c, n_xi, n_eta)):
            np.testing.assert_array_equal(a, b)
    r = np.array([0.35, 1.7])
    np.testing.assert_array_equal(ten.exact_energy(r), jen.exact_energy(r))
    np.testing.assert_allclose(texact.exact_electronic_energy(1.0, "2psu"),
                               jen.exact_energy_ode([1.0], "2psu")[0],
                               rtol=1e-13)
