"""PyTorch port of the separable-spheroidal ansatz against the JAX package.

The same parameters (drawn by the JAX package, or the shipped artifacts) and
the same numpy-seeded points go through ``ansatz.psi_fwdlap`` / ``psi`` of
both packages, in float64. Tolerances: psi rtol 1e-12, lap rtol 1e-10, E rtol
1e-14 (those of tests/test_pallas_separable.py); the ungerade sector's psi
cancels near the mid-plane, hence the small absolute floors."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.io import checkpoint as jckpt
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "artifacts")


@pytest.fixture(autouse=True, scope="module")
def no_jax_cache_writes():
    """Keep the JAX executables these comparisons compile out of the
    committed persistent cache (tests/conftest.py points it into the repo):
    no compile is slow enough to be written while a port test module runs.
    The other test_torch_* modules import this fixture to get the same."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    yield
    jax.config.update(key, old)


def jax_model(p_sym=1, hidden=16, seed=0):
    """JAX-drawn params with the zero-initialised output layers knocked off
    zero (as tests/test_pallas_separable.py does), in numpy."""
    mcfg = pqs.ModelConfig(arch="separable", inversion_symmetry=p_sym,
                           hidden=hidden)
    params = jans.init_params(jax.random.PRNGKey(seed), mcfg, jnp.float64)
    for k in ("lamout", "muout"):
        params[k]["w"] = params[k]["w"] + 0.15
        params[k]["b"] = params[k]["b"] + 0.05
    params["beta2"]["w"] = params["beta2"]["w"] + 0.2
    tm = tcfg.ModelConfig(arch="separable", inversion_symmetry=p_sym,
                          hidden=hidden)
    return mcfg, tm, jax.tree.map(np.asarray, params)


def points(n=1100, seed=1, lo=-6.0, hi=6.0, r_lo=0.5, r_hi=3.0):
    rng = np.random.default_rng(seed)
    x, y, z = (rng.uniform(lo, hi, n) for _ in range(3))
    return x, y, z, rng.uniform(r_lo, r_hi, n)


def as_t(*arrays):
    return [torch.as_tensor(a, dtype=torch.float64) for a in arrays]


def load_artifact(name):
    params, _ = jckpt.load_params(os.path.join(ARTIFACTS, name))
    params = params.get("params", params)
    return {k: {kk: np.asarray(vv, np.float64) for kk, vv in v.items()}
            for k, v in params.items()}


def assert_fwdlap_match(mcfg, tm, params, pts, atol_psi=1e-14,
                        atol_lap=1e-12):
    s, e = jans.psi_fwdlap(params, mcfg, *pts)
    tp = tans.from_jax_params(params, device="cpu")
    st, et = tans.psi_fwdlap(tp, tm, *as_t(*pts))
    np.testing.assert_allclose(st.v[..., 0].numpy(), np.asarray(s.v[..., 0]),
                               rtol=1e-12, atol=atol_psi)
    np.testing.assert_allclose(st.l[..., 0].numpy(), np.asarray(s.l[..., 0]),
                               rtol=1e-10, atol=atol_lap)
    np.testing.assert_allclose(st.g[..., 0].numpy(), np.asarray(s.g[..., 0]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(et.numpy(), np.asarray(e), rtol=1e-14)
    pv, ev = jans.psi(params, mcfg, *pts)
    pt, e2 = tans.psi(tp, tm, *as_t(*pts))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pv), rtol=1e-12,
                               atol=atol_psi)
    np.testing.assert_allclose(e2.numpy(), np.asarray(ev), rtol=1e-14)


@pytest.mark.parametrize("hidden", [4, 16])
@pytest.mark.parametrize("p_sym", [1, -1])
def test_psi_fwdlap_matches_jax(hidden, p_sym):
    mcfg, tm, params = jax_model(p_sym, hidden)
    assert_fwdlap_match(mcfg, tm, params, points())


@pytest.mark.parametrize("name,p_sym", [("flagship_separable.npz", 1),
                                        ("ungerade_separable.npz", -1)])
def test_shipped_artifacts_match_jax(name, p_sym):
    params = load_artifact(name)
    mcfg = pqs.ModelConfig(arch="separable", inversion_symmetry=p_sym)
    tm = tcfg.ModelConfig(arch="separable", inversion_symmetry=p_sym)
    assert_fwdlap_match(mcfg, tm, params,
                        points(n=2000, seed=4, lo=-8, hi=8, r_lo=0.2,
                               r_hi=4.0))


def test_init_is_exactly_gz():
    """Zero output layers: psi == the GZ physics part of the same heads."""
    tm = tcfg.ModelConfig(arch="separable")
    params = tans.init_params(tm, seed=3, dtype=torch.float64, device="cpu")
    x, y, z, r = as_t(*points(n=64))
    psi, _ = tans.psi(params, tm, x, y, z, r)
    a = tans.orbital_exponent(params, r)
    b = tans.gz_exponent(params, r, 1, a)
    r1 = torch.sqrt((x - r) ** 2 + y ** 2 + z ** 2)
    r2 = torch.sqrt((x + r) ** 2 + y ** 2 + z ** 2)
    gz = torch.exp(-a * r1 - b * r2) + torch.exp(-a * r2 - b * r1)
    np.testing.assert_allclose(psi.numpy(), gz.numpy(), rtol=1e-14)
    np.testing.assert_allclose(a.numpy(), 1.0, rtol=1e-14)
    np.testing.assert_allclose(b.numpy(), 0.1, rtol=1e-14)


def test_init_layout_matches_jax():
    """Same keys, shapes and head biases as the JAX init; wide_alpha
    selects the xalpha head."""
    for wide in (False, True):
        mcfg = pqs.ModelConfig(arch="separable", wide_alpha=wide)
        tm = tcfg.ModelConfig(arch="separable", wide_alpha=wide)
        jp = jans.init_params(jax.random.PRNGKey(0), mcfg, jnp.float64)
        tp = tans.init_params(tm, seed=0, dtype="float64", device="cpu")
        assert sorted(jp) == sorted(tp)
        for k in jp:
            for f in jp[k]:
                assert tuple(tp[k][f].shape) == jp[k][f].shape, (k, f)
        for k in ("lamout", "muout", "beta2", "eout"):
            np.testing.assert_array_equal(tp[k]["b"].numpy(),
                                          np.asarray(jp[k]["b"]))


@pytest.mark.parametrize("p_sym", [1, -1])
def test_exact_inversion_parity(p_sym):
    _, tm, params = jax_model(p_sym, 16, seed=3)
    tp = tans.from_jax_params(params, device="cpu")
    x, y, z, r = as_t(*points(n=256))
    a, _ = tans.psi(tp, tm, x, y, z, r)
    b, _ = tans.psi(tp, tm, -x, -y, -z, r)
    np.testing.assert_allclose(b.numpy(), p_sym * a.numpy(), rtol=1e-13)


def test_params_round_trip():
    _, _, params = jax_model()
    tp = tans.from_jax_params(params, dtype="float32", device="cpu")
    assert tp["lam2"]["w"].dtype == torch.float32
    back = tans.to_numpy_params(tans.from_jax_params(params, device="cpu"))
    for k in params:
        for f in params[k]:
            np.testing.assert_array_equal(back[k][f], params[k][f])
