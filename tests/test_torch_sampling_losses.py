"""Collocation sampling and the residual loss of the PyTorch port against
the JAX package.

- The clamp-and-mask step applied to the same raw points gives JAX's batch
  bit for bit; both samplers keep their bounds and mask semantics.
- ``loss_fn`` on one identical batch equals the JAX ``losses.loss_fn`` (its
  XLA forward-Laplacian path) in value and in every parameter gradient,
  rtol 1e-10 (float64), for the plain, lcao-weighted, scale-invariant and
  correction-regularised losses."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.ops import sampling as jsam
from pinn_for_quantum_wavefunction_surfaces_tpu.training import losses as jlo
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    sampling as tsam
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    losses as tlo

from test_torch_pallas_train import sym_model
from test_torch_separable import no_jax_cache_writes  # noqa: F401


def port_cfg(jcfg):
    """The port Config with the same field values as a JAX Config."""
    return tcfg.Config(
        model=tcfg.ModelConfig(**dataclasses.asdict(jcfg.model)),
        domain=tcfg.DomainConfig(**dataclasses.asdict(jcfg.domain)),
        train=tcfg.TrainConfig(**{
            k: v for k, v in dataclasses.asdict(jcfg.train).items()
            if k not in ("kernel", "remat")}),
        convention=jcfg.convention, dtype=jcfg.dtype)


def to_port_batch(batch):
    return tsam.Batch(*(torch.as_tensor(np.array(a)) for a in batch))


def test_clamp_and_mask_match_jax_bitwise():
    """A small box and a wide cutoff make many points clamp: the same raw
    points (JAX's draw with cutoff 0, which clamps nothing) through the
    port's clamp_and_mask equal JAX's clamped batch bit for bit."""
    dom = pqs.DomainConfig(box=1.5, cutoff=0.6, bc_cutoff=1.2, r_lo=0.2,
                           r_hi=1.0)
    jcfg = pqs.Config(domain=dom, dtype="float64")
    key = jax.random.PRNGKey(5)
    raw = jsam.sample_batch(key, dataclasses.replace(
        jcfg, domain=dataclasses.replace(dom, cutoff=0.0)), n=4096)
    want = jsam.sample_batch(key, jcfg, n=4096)
    got = tsam.clamp_and_mask(port_cfg(jcfg), *(torch.as_tensor(
        np.array(a)) for a in raw[:4]))
    assert int(np.sum(np.asarray(raw.x) != np.asarray(want.x))) > 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got.bc1.sum()) < 4096


@pytest.mark.parametrize("sampler", ["uniform", "mixed"])
def test_sample_batch_bounds_and_masks(sampler):
    cfg = tcfg.Config(domain=tcfg.DomainConfig(sampler=sampler),
                      dtype="float64")
    dom = cfg.domain
    gen = torch.Generator().manual_seed(3)
    b = tsam.sample_batch(gen, cfg, n=20000)
    again = tsam.sample_batch(torch.Generator().manual_seed(3), cfg,
                              n=20000)
    for u, v in zip(b, again):
        assert torch.equal(u, v)
    for t in (b.x, b.y, b.z):
        assert t.dtype == torch.float64 and t.shape == (20000,)
        assert float(t.abs().max()) <= dom.box
    assert dom.r_lo <= float(b.r.min()) and float(b.r.max()) <= dom.r_hi
    r1 = torch.sqrt((b.x - b.r) ** 2 + b.y ** 2 + b.z ** 2)
    r2 = torch.sqrt((b.x + b.r) ** 2 + b.y ** 2 + b.z ** 2)
    assert torch.equal(b.bc1, r1 >= dom.bc_cutoff)
    assert torch.equal(b.bc2, r2 >= dom.bc_cutoff)
    assert float(torch.minimum(r1, r2).min()) >= dom.cutoff
    near = torch.minimum(r1, r2)
    n_f = int(dom.focus_frac * 20000) if sampler == "mixed" else 0
    if n_f:
        # the shells: radius floor + Gamma(3, scale) (mean 3.15 bohr here)
        # about a nucleus, against ~11 bohr for the uniform cube
        assert float(near[:n_f].mean()) < 4.0 < float(near[n_f:].mean())
        assert float(near[:n_f].min()) >= dom.focus_floor - 1.0


def test_masked_mean_matches_jax():
    rng = np.random.default_rng(2)
    v = rng.normal(size=64)
    for mask in (rng.random(64) < 0.3, np.zeros(64, bool)):
        want = float(jsam.masked_mean(v, mask))
        got = float(tsam.masked_mean(torch.as_tensor(v),
                                     torch.as_tensor(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-15)


_VG = jax.jit(jax.value_and_grad(jlo.loss_fn, has_aux=True),
              static_argnums=1)


@pytest.mark.parametrize("setting", ["plain", "lcao", "scale_invariant",
                                     "correction_reg"])
def test_loss_fn_matches_jax(setting):
    p_sym = -1 if setting == "scale_invariant" else 1
    mcfg, _, params = sym_model(p_sym, gz=True, alpha=True, hidden=4)
    train = {"plain": {}, "lcao": dict(residual_weight="lcao"),
             "scale_invariant": dict(scale_invariant=True),
             "correction_reg": dict(correction_reg=1e-2)}[setting]
    jcfg = pqs.smoke_config(dtype="float64")
    jcfg = dataclasses.replace(
        jcfg, model=mcfg, train=dataclasses.replace(jcfg.train, **train),
        domain=dataclasses.replace(jcfg.domain, box=6.0, bc_cutoff=5.0))
    batch = jsam.sample_batch(jax.random.PRNGKey(3), jcfg, n=512)
    (l_j, aux_j), g_j = _VG(params, jcfg, batch)
    tp = tans.from_jax_params(params, device="cpu")
    l_t, aux_t, g_t = tlo.loss_and_grad(tp, port_cfg(jcfg),
                                        to_port_batch(batch))
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-10)
    for a, b in zip(aux_t, aux_j):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-10)
    for k in params:
        for f in params[k]:
            np.testing.assert_allclose(g_t[k][f].numpy(),
                                       np.asarray(g_j[k][f]), rtol=1e-10,
                                       atol=1e-14, err_msg=f"{k}/{f}")
