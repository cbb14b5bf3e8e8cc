"""The spline E(R) table (analysis/etab.py) and the E-head distillation
(training/distill.py) of the PyTorch port.

The spline functions equal the JAX package's (the same numpy arithmetic,
rtol 1e-15) and scipy's not-a-knot CubicSpline (rtol 1e-10); the table of
the shipped flagship equals artifacts/evaluated.npz's at three knots (rtol
1e-12: the JAX package reproduces those bit for bit, the port sums in
another order); the Rayleigh targets equal the JAX package's on all three
grids (rtol 1e-12); distillation changes only the E head and lowers its fit
RMS. torch's L-BFGS takes another path than optax's, so the fit is held to
its RMS, not to the JAX head."""

import os

import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.analysis import etab as jetab
from pinn_for_quantum_wavefunction_surfaces_tpu.training import \
    distill as jdistill
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    etab as tetab
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    distill as tdistill

from test_torch_separable import (ARTIFACTS, load_artifact,  # noqa: F401
                                  no_jax_cache_writes)

SEP64 = tcfg.Config(dtype="float64", model=tcfg.ModelConfig(arch="separable"))


def knots(n=12, seed=2):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.2, 4.0, n))
    return x, -0.6 - 0.5 * np.exp(-x) + 0.01 * rng.normal(size=n)


def test_spline_matches_jax_and_scipy():
    x, y = knots()
    r = np.linspace(0.1, 4.2, 57)   # both ends extrapolate
    m = tetab.cubic_spline_coeffs(x, y)
    np.testing.assert_allclose(m, jetab.cubic_spline_coeffs(x, y),
                               rtol=1e-15)
    table = {"R": x, "E": y}
    cs = CubicSpline(x, y)   # not-a-knot by default
    for got, want_j, want_s in (
            (tetab.spline_eval(x, y, m, r), jetab.spline_eval(x, y, m, r),
             cs(r)),
            (tetab.spline_eval_deriv(x, y, m, r),
             jetab.spline_eval_deriv(x, y, m, r), cs(r, 1)),
            (tetab.energy_from_table(table, r),
             jetab.energy_from_table(table, r), cs(r)),
            (tetab.force_from_table(table, r),
             jetab.force_from_table(table, r), -cs(r, 1) + 0.5 / r ** 2)):
        np.testing.assert_allclose(got, want_j, rtol=1e-15)
        np.testing.assert_allclose(got, want_s, rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError):
        tetab.cubic_spline_coeffs(x[:3], y[:3])


def test_build_table_matches_evaluated_artifact():
    """Three knots of the shipped table, rebuilt from the flagship's psi
    through the port's spheroidal quotient (K1-fwd's module)."""
    path = os.path.join(ARTIFACTS, "evaluated.npz")
    shipped = tetab.load_table(path)
    want_j = jetab.load_table(path)
    for k in ("R", "E"):
        np.testing.assert_array_equal(shipped[k], want_j[k])
    assert len(shipped["R"]) == 153
    pick = [0, 76, 152]
    params = tans.from_jax_params(load_artifact("flagship_separable.npz"),
                                  device="cpu")
    got = tetab.build_table(params, SEP64, r_values=shipped["R"][pick])
    np.testing.assert_array_equal(got["R"], shipped["R"][pick])
    np.testing.assert_allclose(got["E"], shipped["E"][pick], rtol=1e-12)
    # the default knots are the shipped ones (log-clustered in R + 0.3)
    dom = SEP64.domain
    t = np.linspace(np.log(dom.r_lo + 0.3), np.log(dom.r_hi + 0.3), 153)
    r = np.exp(t) - 0.3
    r[0], r[-1] = dom.r_lo, dom.r_hi
    np.testing.assert_array_equal(r, shipped["R"])


@pytest.mark.parametrize("grid", ["spheroidal", "adapted", "uniform"])
def test_rayleigh_targets_match_jax(grid):
    np_params = load_artifact("flagship_separable.npz")
    jcfg = pqs.Config(dtype="float64", model=pqs.ModelConfig(
        arch="separable"))
    r = [0.9, 1.7]
    _, want = jdistill.rayleigh_targets(np_params, jcfg, r, n=16, grid=grid)
    r_got, got = tdistill.rayleigh_targets(
        tans.from_jax_params(np_params, device="cpu"), SEP64, r, n=16,
        grid=grid)
    np.testing.assert_array_equal(r_got, r)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_distill_touches_only_the_head_and_lowers_fit_rms():
    np_params = load_artifact("flagship_separable.npz")
    rng = np.random.default_rng(11)
    # knock the shipped head off its fit
    np_params["e2"]["w"] = np_params["e2"]["w"] + 0.01 * rng.normal(
        size=np_params["e2"]["w"].shape)
    params = tans.from_jax_params(np_params, device="cpu")
    r = np.linspace(0.5, 3.5, 13)
    r, targets = tdistill.rayleigh_targets(params, SEP64, r)
    with torch.no_grad():
        e0 = tans.energy(params, torch.as_tensor(r)).numpy()
    rms0 = float(np.sqrt(np.mean((e0 - targets) ** 2)))
    new, info = tdistill.distill(params, SEP64, r_values=r, steps=300)
    np.testing.assert_array_equal(info["targets"], targets)
    assert info["fit_rms"] < 0.05 * rms0, (info["fit_rms"], rms0)
    assert info["fit_rms"] < 1e-5
    assert sorted(new) == sorted(params)
    for k in params:
        for f in params[k]:
            same = torch.equal(new[k][f], params[k][f])
            assert same == (k not in ("e1", "e2", "eout")), (k, f)
            assert not new[k][f].requires_grad


# fit_energy_head's fit RMS at smoke steps (100 Adam, 30 L-BFGS) on the
# shipped flagship with a perturbed head, as recorded before the fit moved
# to the host (it ran on the params' device, here the CPU): moving it must
# change no bit on the CPU
FIT_RMS_BEFORE = {"float64": 7.702212025317947e-05,
                  "float32": 7.932721461153505e-05}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fit_energy_head_runs_on_the_host(dtype):
    """The head comes back on the params' device and in their dtype, every
    other subtree is the same object, and the fit RMS equals the recorded
    one (rtol 1e-12)."""
    np_params = load_artifact("flagship_separable.npz")
    rng = np.random.default_rng(11)
    np_params["e2"]["w"] = np_params["e2"]["w"] + 0.01 * rng.normal(
        size=np_params["e2"]["w"].shape)
    params = tans.from_jax_params(np_params, dtype=dtype, device="cpu")
    r = np.linspace(0.5, 3.5, 13)
    t = -0.6 - 0.5 * np.exp(-r)
    new = tdistill.fit_energy_head(params, r, t, steps=100, lbfgs_steps=30)
    for k in params:
        if k in tdistill.HEAD:
            for f, v in new[k].items():
                assert v.device == params[k][f].device
                assert v.dtype == params[k][f].dtype == getattr(torch, dtype)
                assert not v.requires_grad
        else:
            assert new[k] is params[k], k
    with torch.no_grad():
        e = tans.energy(new, torch.as_tensor(r, dtype=getattr(torch, dtype)))
    rms = float(np.sqrt(np.mean((e.double().numpy() - t) ** 2)))
    np.testing.assert_allclose(rms, FIT_RMS_BEFORE[dtype], rtol=1e-12)
