"""The port's deterministic variational trainer against the JAX package.

float64 throughout. Batches: bitwise equal (both build them from the same
numpy grids). quotient_loss: value rtol 1e-11, every parameter's gradient
rtol 1e-8 (tests/test_pallas_separable.py:93-114). The fixed-R polish
golden of tests/test_separable.py:156-175 from the port's own seeded GZ init:
below 0.25 mHa and at or above -1e-6 mHa of the exact oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.training import \
    variational as jvar
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    energy as ten
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    variational as tvar

from test_torch_excited import one_torch_thread  # noqa: F401
from test_torch_separable import jax_model, no_jax_cache_writes  # noqa: F401


def configs(p_sym=1, hidden=16, **domain):
    jc = pqs.Config(dtype="float64", model=pqs.ModelConfig(
        arch="separable", inversion_symmetry=p_sym, hidden=hidden))
    tc = tcfg.Config(dtype="float64", model=tcfg.ModelConfig(
        arch="separable", inversion_symmetry=p_sym, hidden=hidden))
    if domain:
        jc = dataclasses.replace(jc, domain=dataclasses.replace(jc.domain,
                                                                **domain))
        tc = dataclasses.replace(tc, domain=dataclasses.replace(tc.domain,
                                                                **domain))
    return jc, tc


def assert_batches_equal(vt, vj):
    for a, b in zip(vt, vj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("domain", [{}, {"r_cluster": "log"},
                                    {"fixed_r": 1.3}, {"xi_span": 30.0}])
def test_spheroidal_vbatch_bitwise(domain):
    jc, tc = configs(**domain)
    vj = jvar.spheroidal_vbatch(jc, n_r=3, n_xi=12, n_eta=8)
    vt = tvar.spheroidal_vbatch(tc, n_r=3, n_xi=12, n_eta=8, device="cpu")
    assert_batches_equal(vt, vj)


def test_dual_grid_and_validation_batches():
    """The polish's training batch (grid 1 padded with zero-weight points
    at coordinate 1, stacked on the coprime grid 2) and its third grid,
    as polish_spheroidal builds them in the JAX package."""
    jc, tc = configs()
    n_r, n_xi, n_eta = 3, 12, 8
    vb = jvar.spheroidal_vbatch(jc, n_r=n_r, n_xi=n_xi, n_eta=n_eta)
    vb2 = jvar.spheroidal_vbatch(jc, n_r=n_r,
                                 n_xi=jvar._coprime_size(n_xi, 17),
                                 n_eta=jvar._coprime_size(n_eta, 13))
    pad = vb2.x.shape[1] - vb.x.shape[1]
    po = lambda a: jnp.pad(a, ((0, 0), (0, pad)), constant_values=1.0)
    pz = lambda a: jnp.pad(a, ((0, 0), (0, pad)))
    want = jvar.VBatch(jnp.concatenate([po(vb.x), vb2.x]),
                       jnp.concatenate([po(vb.y), vb2.y]),
                       jnp.concatenate([po(vb.z), vb2.z]),
                       jnp.concatenate([pz(vb.w), vb2.w]),
                       jnp.concatenate([vb.r, vb2.r]))
    got = tvar.dual_grid_vbatch(tc, n_r, n_xi, n_eta, device="cpu")
    assert_batches_equal(got, want)
    # the flagship recipe's sizes: 57 x 37 second grid, 71 x 47 third
    assert (tvar._coprime_size(40, 17), tvar._coprime_size(24, 13)) == (57, 37)
    val = tvar.validation_vbatch(tc, 1, 40, 24, device="cpu")
    assert val.x.shape == (1, 71 * 47)
    for n in range(2, 60):
        assert tvar._coprime_size(n, 17) == jvar._coprime_size(n, 17)


@pytest.mark.parametrize("hidden", [4, 16])
@pytest.mark.parametrize("p_sym", [1, -1])
def test_quotient_loss_value_and_gradients_match_jax(hidden, p_sym):
    mcfg, _, params = jax_model(p_sym, hidden)
    jc, tc = configs(p_sym, hidden)
    vbj = jvar.spheroidal_vbatch(jc, n_r=3, n_xi=12, n_eta=8)
    vg = jax.jit(jax.value_and_grad(jvar.quotient_loss, has_aux=True),
                 static_argnums=1)
    (l_j, aux_j), g_j = vg(jax.tree.map(jnp.asarray, params), jc, vbj)

    tp = tans.from_jax_params(params, device="cpu")
    leaves = {(k, f): t.requires_grad_(True) for k, v in tp.items()
              for f, t in v.items()}
    vbt = tvar.spheroidal_vbatch(tc, n_r=3, n_xi=12, n_eta=8, device="cpu")
    l_t, aux_t = tvar.quotient_loss(tp, tc, vbt)
    grads = torch.autograd.grad(l_t, list(leaves.values()))
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-11)
    np.testing.assert_allclose(aux_t["e_r"].detach().numpy(),
                               np.asarray(aux_j["e_r"]), rtol=1e-11)
    for (k, f), g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[k][f]),
                                   rtol=1e-8, atol=1e-11, err_msg=f"{k}/{f}")


def test_adam_schedule_matches_optax_staircase():
    """The warmup's rate (``warmup_lr``, set on its Adam before each step)
    reproduces optax.exponential_decay(lr, steps // 4, 0.5,
    staircase=True) on the int32 step count that optax's update passes it
    (a float32 value), step for step."""
    steps, lr = 10, 3e-3
    sched = optax.exponential_decay(lr, transition_steps=steps // 4,
                                    decay_rate=0.5, staircase=True)
    for i in range(steps):
        np.testing.assert_allclose(tvar.warmup_lr(lr, steps, i),
                                   float(sched(jnp.int32(i))), rtol=1e-15)


def test_adam_warmup_matches_jax():
    """The polish's Adam warmup (``AdamWarmup``: optax's update as
    in-place tensor ops on one flat vector) against the JAX package's
    scan-chunked _adam_minimize, on the same dual spheroidal grid from the
    same JAX init of the separable family: 12 steps, so that the staircase
    halves the rate three times; params within rtol 1e-9 (the tolerance of
    test_adam_steps_and_resume_match_jax), the logged loss within 1e-10."""
    _, _, params = jax_model(1, 8)
    jc, tc = configs(hidden=8)
    vb = tvar.dual_grid_vbatch(tc, 2, 10, 8, device="cpu")
    vbj = jvar.VBatch(*(jnp.asarray(a.numpy()) for a in vb))
    logs_j, logs_t = [], []
    want = jvar._adam_minimize(jax.tree.map(jnp.asarray, params), jc, vbj,
                               12, 1.0,
                               log_cb=lambda i, m: logs_j.append((i, m)))
    got = tvar._adam_minimize(tans.from_jax_params(params, device="cpu"),
                              tc, vb, 12, 1.0,
                              log_cb=lambda i, m: logs_t.append((i, m)))
    for k in want:
        for f in want[k]:
            np.testing.assert_allclose(got[k][f].numpy(),
                                       np.asarray(want[k][f]), rtol=1e-9,
                                       atol=1e-13, err_msg=f"{k}/{f}")
    assert [i for i, _ in logs_t] == [i for i, _ in logs_j] == [12]
    np.testing.assert_allclose(logs_t[0][1]["E_adam"],
                               logs_j[0][1]["E_adam"], rtol=1e-10)


def test_adam_warmup_then_lbfgs_lowers_the_loss():
    """A short polish on the dual grid with the validation grid: finite,
    lower loss; the best iterate is what comes back."""
    _, tc = configs(hidden=8)
    init = tans.init_params(tc.model, seed=5, dtype="float64", device="cpu")
    vb = tvar.dual_grid_vbatch(tc, 2, 10, 8, device="cpu")
    with torch.no_grad():
        l0 = float(tvar.quotient_loss(init, tc, vb)[0])
    seen = []
    out = tvar.polish_spheroidal(init, tc, n_r=2, n_xi=10, n_eta=8,
                                 steps=6, adam_steps=6,
                                 log_cb=lambda i, m: seen.append(m),
                                 device="cpu")
    with torch.no_grad():
        l1 = float(tvar.quotient_loss(out, tc, vb)[0])
    assert np.isfinite(l1) and l1 < l0
    assert "E_adam" in seen[0] and "E_val" in seen[-1]


def test_lbfgs_restarts_from_best_on_validation_drift():
    """A validation value that jumps above the running best by more than
    restart_margin resets the iterate to the best one (fresh memory)."""
    _, tc = configs(hidden=4)
    init = tans.init_params(tc.model, seed=2, dtype="float64", device="cpu")
    vb = tvar.spheroidal_vbatch(tc, n_r=1, n_xi=8, n_eta=6, device="cpu")
    calls = []

    def val_fn(p):
        calls.append(torch.cat([t.detach().reshape(-1)
                                for v in p.values() for t in v.values()]))
        # the second call reads as a gamed basin, every other improves
        return torch.tensor(1.0 if len(calls) == 2 else -float(len(calls)))

    tvar._lbfgs_minimize(init, tc, vb, steps=3, head_weight=1.0,
                         val_fn=val_fn)
    assert not torch.equal(calls[1], calls[0])
    # step 1 restarted from the best (step-0) iterate with fresh memory, so
    # it repeated step 0's update exactly
    torch.testing.assert_close(calls[2], calls[1], rtol=0, atol=0)


def test_lbfgs_retries_a_rejected_first_trial(monkeypatch):
    """From this init the first L-BFGS trial step raises the objective.
    With one line-search evaluation (torch's default max_eval at
    max_iter=1) the step is rejected and the iterate stays where it was;
    with LBFGS_MAX_LS the search retries a shorter step and the objective
    falls."""
    _, tc = configs(hidden=4)
    init = tans.init_params(tc.model, seed=0, dtype="float64", device="cpu")
    vb = tvar.spheroidal_vbatch(tc, n_r=2, n_xi=8, n_eta=6, device="cpu")
    quotient_loss = tvar.quotient_loss
    values = []

    def counted(*args, **kw):
        out = quotient_loss(*args, **kw)
        values.append(out[0].item())
        return out

    def polish_step(max_ls):
        monkeypatch.setattr(tvar, "LBFGS_MAX_LS", max_ls)
        values.clear()
        out = tvar._lbfgs_minimize(init, tc, vb, steps=1, head_weight=1.0)
        with torch.no_grad():
            final = float(quotient_loss(out, tc, vb)[0])
        # the step's start, its line search, then the final iterate's score
        return len(values) - 2, values[0], final

    budget = tvar.LBFGS_MAX_LS
    monkeypatch.setattr(tvar, "quotient_loss", counted)
    n_ls, start, final = polish_step(0)
    assert n_ls == 1
    assert values[1] > start              # the one trial was rejected ...
    assert final == start                 # ... and nothing moved
    n_ls, start2, final = polish_step(budget)
    assert start2 == start
    assert 1 < n_ls <= budget             # retried within the budget
    assert final < start


def test_fixed_r_polish_golden():
    """The design claim of tests/test_separable.py:156-175 through the
    port: at one R the separable family polishes from the raw GZ init to
    well below 1 mHa. torch.optim.LBFGS needs 60 steps here (the JAX
    package runs optax.lbfgs for 250)."""
    ri = 2.0
    _, tc = configs(fixed_r=ri)
    out = tvar.polish_spheroidal(None, tc, n_r=1, n_xi=40, n_eta=24,
                                 steps=60, head_weight=0.0, device="cpu")
    e = ten.rayleigh_quotient_spheroidal(out, tc, ri)
    exact = float(ten.exact_energy_ode([ri])[0])
    err_mha = 1e3 * (e - exact)
    assert err_mha >= -1e-6, err_mha          # variational bound
    assert err_mha < 0.25, err_mha            # beats the NN-family floor
