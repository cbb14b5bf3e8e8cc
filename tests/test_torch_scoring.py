"""E(R) scoring through the PyTorch port against the JAX package.

The uniform, nucleus-adapted and spheroidal Rayleigh quotients, the LCAO
baseline and ``surface`` of the port's ``analysis/energy.py`` equal the JAX
package's to rtol 1e-12 (float64) on the same params, for a reference-parity
model (K3's), a GZ + alpha model (K2's) and a separable one (K1's), at small
grids (n = 24 an axis). The forward dispatch sends each family to its
kernel module. chip_smoke.py's K3 golden constants are recomputed here
through JAX, so they cannot go stale, and the port reproduces them on the
CPU to 1e-10."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.analysis import \
    energy as jen
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    energy as ten
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    routing as trt

from test_torch_excited import one_torch_thread  # noqa: F401
from test_torch_separable import load_artifact, no_jax_cache_writes  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


def family(name):
    """(JAX config, port config, numpy params) of one scored family in
    float64: K3's reference-parity model (chip_smoke's golden weights), a
    GZ + alpha symmetric model drawn by JAX (head weights knocked off zero)
    and the shipped separable flagship."""
    if name == "reference":
        kw, params = {}, chip_smoke.k3_weights()
    elif name == "gz_alpha":
        kw = dict(gz=True, trainable_exponent=True, hidden=8)
        params = jans.init_params(jax.random.PRNGKey(3),
                                  pqs.ModelConfig(**kw), jnp.float64)
        params["alpha2"]["w"] = params["alpha2"]["w"] + 0.3
        params["beta2"]["w"] = params["beta2"]["w"] + 0.2
        params = jax.tree.map(np.asarray, params)
    else:
        kw, params = dict(arch="separable"), load_artifact(
            "flagship_separable.npz")
    return (pqs.Config(dtype="float64", model=pqs.ModelConfig(**kw)),
            tcfg.Config(dtype="float64", model=tcfg.ModelConfig(**kw)),
            params)


@pytest.mark.parametrize("name", ["reference", "gz_alpha", "separable"])
def test_model_quotients_match_jax(name):
    jc, tc, params = family(name)
    tp = tans.from_jax_params(params, device="cpu")
    ri = 1.3
    pairs = [
        (jen.rayleigh_quotient(params, jc, ri, n=24),
         ten.rayleigh_quotient(tp, tc, ri, n=24)),
        (jen.rayleigh_quotient(params, jc, ri, n=24, scheme="cartwright"),
         ten.rayleigh_quotient(tp, tc, ri, n=24, scheme="cartwright")),
        (jen.rayleigh_quotient_adapted(params, jc, ri, n=24),
         ten.rayleigh_quotient_adapted(tp, tc, ri, n=24)),
        (jen.rayleigh_quotient_spheroidal(params, jc, ri, n_xi=32, n_eta=24),
         ten.rayleigh_quotient_spheroidal(tp, tc, ri, n_xi=32, n_eta=24)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_lcao_quotients_match_jax():
    jc, tc, params = family("reference")
    tp = tans.from_jax_params(params, device="cpu")
    for ri in (0.6, 2.2):
        for jf, tf, kw in (
                (jen.rayleigh_quotient, ten.rayleigh_quotient, dict(n=24)),
                (jen.rayleigh_quotient_adapted, ten.rayleigh_quotient_adapted,
                 dict(n=24)),
                (jen.rayleigh_quotient_spheroidal,
                 ten.rayleigh_quotient_spheroidal, dict(n_xi=32, n_eta=24))):
            np.testing.assert_allclose(tf(tp, tc, ri, which="lcao", **kw),
                                       jf(params, jc, ri, which="lcao", **kw),
                                       rtol=1e-12)


@pytest.mark.parametrize("grid,lcao", [("uniform", True),
                                       ("adapted", False),
                                       ("spheroidal", True)])
def test_surface_matches_jax(grid, lcao, tmp_path):
    jc, tc, params = family("reference")
    r = [0.5, 1.7, 3.0]
    want = jen.surface(params, jc, r_values=r, n=16, lcao=lcao, grid=grid)
    got = ten.surface(tans.from_jax_params(params, device="cpu"), tc,
                      r_values=r, n=16, lcao=lcao, grid=grid)
    assert sorted(got) == sorted(want) == ["E_int", "E_net", "Elcao", "R"]
    np.testing.assert_array_equal(got["R"], want["R"])
    for k in ("E_int", "Elcao", "E_net"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
    # the reference's pickle schema, read back by either package
    path = str(tmp_path / "surf.pkl")
    ten.save_surface(path, got)
    for loader in (ten.load_surface, jen.load_surface):
        back = loader(path)
        assert sorted(back) == sorted(want)
        for k in back:
            assert isinstance(back[k], np.ndarray)
            np.testing.assert_array_equal(back[k], got[k])


def test_k3_golden_constants_match_jax(monkeypatch):
    """chip_smoke.py's phase-14 constants are the JAX package's CPU values
    (recomputed here, so they cannot go stale), and the port's CPU path
    reproduces them to 1e-10, the card's bound. The Cartesian grid runs in
    chunks of 8 slabs, so the port's chunked two-level sum is tested too."""
    jc, tc, params = family("reference")
    tp = tans.from_jax_params(params, device="cpu")
    monkeypatch.setattr(ten, "CHUNK_POINTS", 8 * 80 * 80)
    for ri, (e_u, l_u, e_s, l_s) in chip_smoke.JAX_K3_GOLDEN.items():
        want = (jen.rayleigh_quotient(params, jc, ri, n=80),
                jen.rayleigh_quotient(params, jc, ri, n=80, which="lcao"),
                jen.rayleigh_quotient_spheroidal(params, jc, ri),
                jen.rayleigh_quotient_spheroidal(params, jc, ri,
                                                 which="lcao"))
        np.testing.assert_allclose((e_u, l_u, e_s, l_s), want, rtol=1e-13)
        got = (ten.rayleigh_quotient(tp, tc, ri, n=80),
               ten.rayleigh_quotient(tp, tc, ri, n=80, which="lcao"),
               ten.rayleigh_quotient_spheroidal(tp, tc, ri),
               ten.rayleigh_quotient_spheroidal(tp, tc, ri, which="lcao"))
        np.testing.assert_allclose(got, want, rtol=1e-10)


def test_forward_dispatch_is_keyed_by_the_params(monkeypatch):
    """Reference-parity params go to K3's module, GZ/alpha ones to K2's,
    separable ones to K1's; the minimal family (keyed by the config: its
    params are reference-parity ones) and R-input models to psi_fwdlap."""
    calls = []
    for mod, name in ((trt, "psi_lap_pallas"), (trt, "psi_lap_train"),
                      (trt, "psi_lap_train_separable"),
                      (tans, "psi_fwdlap")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    x = torch.linspace(-3.0, 3.0, 16, dtype=torch.float64)
    r = torch.full_like(x, 1.1)
    for name, want in (("reference", "psi_lap_pallas"),
                       ("gz_alpha", "psi_lap_train"),
                       ("separable", "psi_lap_train_separable")):
        _, tc, params = family(name)
        calls.clear()
        psi, lap = trt.psi_lap_forward(
            tans.from_jax_params(params, device="cpu"), tc.model, x, x, x, r)
        assert calls == [want] and psi.shape == lap.shape == x.shape
    for kw in (dict(arch="minimal"), dict(r_input=True)):
        jm = pqs.ModelConfig(hidden=4, **kw)
        params = jax.tree.map(np.asarray, jans.init_params(
            jax.random.PRNGKey(0), jm, jnp.float64))
        tm = tcfg.ModelConfig(hidden=4, **kw)
        tp = tans.from_jax_params(params, device="cpu")
        calls.clear()
        psi, lap = trt.psi_lap_forward(tp, tm, x, x, x, r)
        assert calls == ["psi_fwdlap"]
        sj, _ = jans.psi_fwdlap(params, jm, *(jnp.asarray(t.numpy())
                                              for t in (x, x, x, r)))
        np.testing.assert_allclose(psi.numpy(), np.asarray(sj.v[..., 0]),
                                   rtol=1e-12)
        np.testing.assert_allclose(lap.numpy(), np.asarray(sj.l[..., 0]),
                                   rtol=1e-12, atol=1e-14)


def test_energy_net_matches_jax():
    _, _, params = family("gz_alpha")
    tp = tans.from_jax_params(params, device="cpu")
    for ri in (0.2, 2.5):
        np.testing.assert_allclose(ten.energy_net(tp, ri),
                                   jen.energy_net(params, ri), rtol=1e-14)
