"""The port's forward-only kernel module of the reference-parity model
(ops/pallas_residual.py, K3) on the CPU: its plain version against the JAX
package's Pallas kernel ``psi_lap_pallas`` (interpret mode, jitted as
tests/test_pallas.py runs it) and against the XLA forward-Laplacian path
``psi_fwdlap``, on a ragged n = 1100.

Tolerances: float64 psi rtol 1e-12 (atol 1e-14: the ungerade psi cancels
near the mid-plane), lap rtol 1e-10 with atol 1e-12; float32 atol 2e-6,
the JAX package's own bound for its kernel (tests/test_pallas.py:32-35).
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py (phase 13)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
from pinn_for_quantum_wavefunction_surfaces_tpu.ops.pallas_residual import \
    psi_lap_pallas as jax_psi_lap_pallas
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_residual as tpr
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_train as tpt

from test_torch_separable import no_jax_cache_writes, points  # noqa: F401

N = 1100   # ragged: not a multiple of any tile or block

_PALLAS = jax.jit(jax_psi_lap_pallas, static_argnums=(1,),
                  static_argnames=("interpret",))
_FWDLAP = jax.jit(jans.psi_fwdlap, static_argnums=(1,))


def ref_model(p_sym=1, hidden=8, ry=0.0, rz=0.0, seed=0):
    """JAX-drawn reference-parity params (numpy) with the JAX and port
    model configs."""
    kw = dict(inversion_symmetry=p_sym, hidden=hidden, ry=ry, rz=rz)
    mcfg = pqs.ModelConfig(**kw)
    params = jans.init_params(jax.random.PRNGKey(seed), mcfg, jnp.float64)
    return mcfg, tcfg.ModelConfig(**kw), jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("p_sym,dtype,ry,rz", [
    (1, "float64", 0.0, 0.0), (-1, "float64", 0.0, 0.0),
    (1, "float32", 0.0, 0.0), (-1, "float32", 0.0, 0.0),
    (1, "float64", 0.3, -0.2),
])
def test_plain_matches_pallas_interpret_and_fwdlap(p_sym, dtype, ry, rz):
    mcfg, tm, params = ref_model(p_sym, ry=ry, rz=rz)
    np_dt = np.dtype(dtype)
    params = jax.tree.map(lambda a: a.astype(np_dt), params)
    pts = [a.astype(np_dt) for a in points(N)]
    psi_j, lap_j = _PALLAS(params, mcfg, *pts, interpret=True)
    s, _ = _FWDLAP(params, mcfg, *pts)
    tp = tans.from_jax_params(params, device="cpu")
    psi_t, lap_t = tpr.psi_lap_pallas(tp, tm, *(torch.as_tensor(a)
                                                for a in pts))
    assert psi_t.dtype == getattr(torch, dtype)
    for want_psi, want_lap in ((psi_j, lap_j), (s.v[..., 0], s.l[..., 0])):
        if dtype == "float64":
            np.testing.assert_allclose(psi_t.numpy(), np.asarray(want_psi),
                                       rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(lap_t.numpy(), np.asarray(want_lap),
                                       rtol=1e-10, atol=1e-12)
        else:
            np.testing.assert_allclose(psi_t.numpy(), np.asarray(want_psi),
                                       atol=2e-6)
            np.testing.assert_allclose(lap_t.numpy(), np.asarray(want_lap),
                                       atol=2e-6)
    assert tpr.launches == {"residual_fwd": 0}


def test_plain_equals_k2_plain_with_unit_exponent():
    """K3 is K2's forward with a = 1, b = 0 and the gate moved in: the two
    plain versions agree bit for bit."""
    _, tm, params = ref_model(1, hidden=16)
    x, y, z, r = (torch.as_tensor(a) for a in points(N))
    tp = tans.from_jax_params(params, device="cpu")
    with torch.no_grad():
        psi2, lap2, _ = tpt.psi_lap_train(tp, tm, x, y, z, r)
    psi3, lap3 = tpr.psi_lap_pallas(tp, tm, x, y, z, r)
    assert torch.equal(psi3, psi2) and torch.equal(lap3, lap2)


def test_rejects_what_jax_rejects():
    """The NotImplementedErrors of tests/test_pallas.py:38-52: the minimal
    architecture, alpha/GZ heads (never silently ignored) and R input."""
    x = torch.ones(8, dtype=torch.float64)
    cases = [pqs.minimal_config().model,
             pqs.ModelConfig(gz=True, trainable_exponent=True),
             pqs.ModelConfig(trainable_exponent=True),
             pqs.ModelConfig(r_input=True)]
    for mcfg in cases:
        params = jax.tree.map(np.asarray, jans.init_params(
            jax.random.PRNGKey(0), mcfg, jnp.float64))
        xj = jnp.ones((8,), jnp.float64)
        with pytest.raises(NotImplementedError):
            jax_psi_lap_pallas(params, mcfg, xj, xj, xj, xj, interpret=True)
        tm = tcfg.ModelConfig(arch=mcfg.arch, gz=mcfg.gz,
                              trainable_exponent=mcfg.trainable_exponent,
                              r_input=mcfg.r_input)
        with pytest.raises(NotImplementedError):
            tpr.psi_lap_pallas(tans.from_jax_params(params, device="cpu"),
                               tm, x, x, x, x)


def test_refuses_inputs_that_require_grad():
    _, tm, params = ref_model(1, hidden=4)
    x, y, z, r = (torch.as_tensor(a) for a in points(64))
    tp = tans.from_jax_params(params, device="cpu")
    tp["h2"]["w"].requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        tpr.psi_lap_pallas(tp, tm, x, y, z, r)
    with pytest.raises(ValueError, match="no backward"):
        tpr.psi_lap_pallas(tans.from_jax_params(params, device="cpu"), tm,
                           x.requires_grad_(True), y, z, r)
    with torch.no_grad():   # nothing to differentiate: it runs
        psi, _ = tpr.psi_lap_pallas(tp, tm, x, y, z, r)
    assert not psi.requires_grad


def test_cuda_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises: never the plain path."""
    _, tm, params = ref_model(1, hidden=16)
    pts = [torch.as_tensor(a) for a in points(64)]
    ws = tpr.kernel_weights(tans.from_jax_params(params, device="cpu"), tm,
                            torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpr.residual_fwd_cuda(ws, *pts)
    _, tm5, p5 = ref_model(1, hidden=5)
    ws5 = tpr.kernel_weights(tans.from_jax_params(p5, device="cpu"), tm5,
                             torch.float64)
    with pytest.raises(ValueError, match="hidden=5"):
        tpr.residual_fwd_cuda(ws5, *pts)
    assert tpr.launches == {"residual_fwd": 0}


@pytest.mark.parametrize("p_sym", [1, -1])
def test_params_without_heads_round_trip(p_sym):
    """from_jax_params / to_numpy_params carry a tree without alpha/beta
    heads across unchanged, and the kernel weights are its leaves (the
    ungerade output bias a constant 0)."""
    _, tm, params = ref_model(p_sym, hidden=16)
    assert not any(k in params for k in ("alpha1", "beta1"))
    tp = tans.from_jax_params(params, device="cpu")
    assert tpr.is_reference_parity(tp)
    back = tans.to_numpy_params(tp)
    assert sorted(back) == sorted(params)
    for k in params:
        for f in params[k]:
            np.testing.assert_array_equal(back[k][f], params[k][f])
    ws = tpr.kernel_weights(tp, tm, torch.float64)
    assert [tuple(w.shape) for w in ws] == list(tpr.weight_shapes(16, 10))
    ob = 0.0 if p_sym < 0 else float(params["out"]["b"][0])
    assert float(ws[5][0, 0]) == ob
    np.testing.assert_array_equal(ws[6].numpy(), params["gate1"]["w"])
    np.testing.assert_array_equal(ws[8].numpy(), params["gate2"]["w"])
