"""Point cotangents (point_grads=True) of the port's fused kernels on the
CPU: K1 (ops/pallas_separable.py, the separable family) and K2
(ops/pallas_train.py, the symmetric family with GZ + alpha), both sectors.

With point_grads the gradient reaches x, y, z and r, r's through the kernel
and through the R-only heads. The port's plain adjoints (the arithmetic the
CUDA backward kernels' point-gradient instantiations transliterate) are
held against the JAX package's Pallas kernels with point_grads=True (in
interpret mode, at H = 4 as its own tests run them), against torch autograd
of the plain forwards, and against autograd of the port's forward-Laplacian
ansatz. Tolerances (float64): rtol 1e-8, atol 1e-12, those of
tests/test_pallas_separable.py and tests/test_pallas_train.py for the same
point cotangents. The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py (phase 17)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_for_quantum_wavefunction_surfaces_tpu.ops import \
    pallas_separable as jps
from pinn_for_quantum_wavefunction_surfaces_tpu.ops import pallas_train as jpt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_separable as tps
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_train as tpt

from test_torch_pallas_separable import kernel_inputs as k1_inputs
from test_torch_pallas_train import kernel_inputs as k2_inputs
from test_torch_pallas_train import sym_model
from test_torch_separable import (as_t, jax_model,  # noqa: F401
                                  no_jax_cache_writes, points)

N = 64
FAMILIES = ("separable", "symmetric")
RTOL, ATOL = 1e-8, 1e-12


def model(family, p_sym):
    """(JAX config, port config, numpy params, JAX entry point, port entry
    point) at H = 4."""
    if family == "separable":
        mcfg, tm, params = jax_model(p_sym, hidden=4)
        return (mcfg, tm, params, jps.psi_lap_train_separable,
                tps.psi_lap_train_separable)
    mcfg, tm, params = sym_model(p_sym, gz=True, alpha=True, hidden=4)
    return mcfg, tm, params, jpt.psi_lap_train, tpt.psi_lap_train


def objective(psi, lap):
    return (psi ** 2).sum() + lap.sum()


@functools.lru_cache(maxsize=None)
def jax_point_grads(family, p_sym):
    """d/d(x, y, z, r) of sum(psi^2) + sum(lap) through the JAX package's
    kernel with point_grads=True (interpret mode), one compile a case."""
    mcfg, _, params, jfn, _ = model(family, p_sym)

    def f(x, y, z, r):
        psi, lap, _ = jfn(params, mcfg, x, y, z, r, interpret=True,
                          point_grads=True)
        return objective(psi, lap)

    grads = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, points(N)))
    return tuple(np.asarray(g) for g in grads)


def port_point_grads(family, p_sym, point_grads=True):
    """The same gradients through the port's entry point (the plain adjoint
    on the CPU) and the params' leaves' gradients."""
    _, tm, params, _, tfn = model(family, p_sym)
    tp = tans.from_jax_params(params, device="cpu")
    leaves = [t.requires_grad_(True) for v in tp.values() for t in v.values()]
    xyzr = [t.requires_grad_(True) for t in as_t(*points(N))]
    psi, lap, _ = tfn(tp, tm, *xyzr, point_grads=point_grads)
    grads = torch.autograd.grad(objective(psi, lap), xyzr + leaves,
                                allow_unused=True)
    return grads[:4], grads[4:]


@pytest.mark.parametrize("coord", ["x", "y", "z", "r"])
@pytest.mark.parametrize("p_sym", [1, -1])
@pytest.mark.parametrize("family", FAMILIES)
def test_point_grads_match_jax(family, p_sym, coord):
    """Each of dx, dy, dz, dr (r including the heads) against the JAX
    package's psi_lap_train[_separable](..., point_grads=True)."""
    i = "xyzr".index(coord)
    want = jax_point_grads(family, p_sym)[i]
    got = port_point_grads(family, p_sym)[0][i].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def plain_inputs(family, p_sym):
    """(kernel inputs, plain forward, plain adjoint) as the entry points
    build them: weights, then a, b (and g for K2)."""
    _, tm, params, _, _ = model(family, p_sym)
    pts = points(N)
    if family == "separable":
        ws, a, b = k1_inputs(params, tm, pts)
        return (list(ws), [a, b], tps.psi_lap_separable_plain,
                tps.psi_lap_separable_vjp_plain)
    ws, a, b, g = k2_inputs(params, tm, pts[3])
    return (list(ws), [a, b, g], tpt.psi_lap_train_plain,
            tpt.psi_lap_train_vjp_plain)


@pytest.mark.parametrize("p_sym", [1, -1])
@pytest.mark.parametrize("family", FAMILIES)
def test_plain_point_vjp_matches_autograd_and_fwdlap(family, p_sym):
    """The hand-written adjoint with point_grads=True against torch
    autograd of the plain forward in every input (weights, exponents,
    points), and the entry point's point gradients against autograd of the
    port's forward-Laplacian ansatz (separable; the plain forward for the
    symmetric family), heads included."""
    ws, per_point, fwd, vjp = plain_inputs(family, p_sym)
    xyzr = as_t(*points(N))
    rng = np.random.default_rng(17)
    dpsi, dlap = as_t(rng.normal(size=N), rng.normal(size=N))
    kw = dict(p_sym=p_sym)
    got = vjp(ws, *per_point, *xyzr, dpsi, dlap, point_grads=True, **kw)
    got = list(got[0]) + list(got[1:])
    leaves = [t.clone().requires_grad_(True) for t in ws + per_point + xyzr]
    psi, lap = fwd(leaves[:len(ws)], *leaves[len(ws):], **kw)
    want = torch.autograd.grad((psi * dpsi).sum() + (lap * dlap).sum(),
                               leaves, allow_unused=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = torch.zeros_like(g) if w is None else w   # K2's ob at P = -1
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL * max(1.0, float(w.abs().max())))

    _, tm, params, _, _ = model(family, p_sym)
    tp = tans.from_jax_params(params, device="cpu")
    x, y, z, r = xyzr_g = [t.requires_grad_(True) for t in as_t(*points(N))]
    if family == "separable":
        s, _ = tans.psi_fwdlap(tp, tm, *xyzr_g)
        psi, lap = s.v[..., 0], s.l[..., 0]
    else:   # psi_fwdlap covers the separable family: the plain forward
        a = tans.orbital_exponent(tp, r)
        psi, lap = tpt.psi_lap_train_plain(
            tpt.kernel_weights(tp, tm, torch.float64), a,
            tans.gz_exponent(tp, r, p_sym, a), tans.gate(tp, r), *xyzr_g,
            p_sym=p_sym)
    want = torch.autograd.grad(objective(psi, lap), xyzr_g)
    for g, w in zip(port_point_grads(family, p_sym)[0], want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("p_sym", [1, -1])
@pytest.mark.parametrize("family", FAMILIES)
def test_point_grads_false_is_todays_path(family, p_sym):
    """point_grads=False: the same weight and exponent gradients as True,
    bit for bit (the same arithmetic), and no gradient for the points in
    the kernel (r's comes from the R-only heads alone)."""
    ws, per_point, _, vjp = plain_inputs(family, p_sym)
    xyzr = as_t(*points(N))
    rng = np.random.default_rng(5)
    dpsi, dlap = as_t(rng.normal(size=N), rng.normal(size=N))
    off = vjp(ws, *per_point, *xyzr, dpsi, dlap, p_sym=p_sym)
    on = vjp(ws, *per_point, *xyzr, dpsi, dlap, p_sym=p_sym,
             point_grads=True)
    assert len(on) == len(off) + 4
    for u, v in zip(list(off[0]) + list(off[1:]),
                    list(on[0]) + list(on[1:len(off)])):
        assert torch.equal(u, v)
    pts_off, leaves_off = port_point_grads(family, p_sym, point_grads=False)
    pts_on, leaves_on = port_point_grads(family, p_sym)
    # x, y, z reach only the kernel; r reaches the heads in both paths
    assert all(g is None for g in pts_off[:3]) and pts_off[3] is not None
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in pts_on)
    for u, v in zip(leaves_off, leaves_on):
        if u is None or v is None:   # leaves the kernel's path never reads
            assert u is None and v is None
        else:
            np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-12,
                                       atol=1e-14 * float(v.abs().max()))


@pytest.mark.parametrize("p_sym", [1, -1])
@pytest.mark.parametrize("family", FAMILIES)
def test_pad_point_adds_exactly_zero(family, p_sym):
    """The kernels' lanes past n evaluate the pad point (1, 1, 1; R = 1,
    a = b = g = 1) with zero cotangents: with point_grads every cotangent,
    dx..dr included, is exactly 0, so a padded tile changes no sum (and
    the kernels write no dx..dr for it)."""
    ws, per_point, fwd, vjp = plain_inputs(family, p_sym)
    one = torch.ones(8, dtype=torch.float64)
    zero = torch.zeros(8, dtype=torch.float64)
    psi, lap = fwd(ws, *([one] * (len(per_point) + 4)), p_sym=p_sym)
    assert bool(torch.isfinite(psi).all() and torch.isfinite(lap).all())
    out = vjp(ws, *([one] * (len(per_point) + 4)), zero, zero, p_sym=p_sym,
              point_grads=True)
    for g in list(out[0]) + list(out[1:]):
        assert bool((g == 0).all())


@pytest.mark.parametrize("family", FAMILIES)
def test_cuda_wrappers_refuse_cpu_tensors(family):
    """point_grads=True on the CUDA wrappers launches or raises: never the
    plain path, and no launch is counted."""
    ws, per_point, _, _ = plain_inputs(family, 1)
    xyzr = as_t(*points(N))
    fn, mod = ((tps.separable_bwd_cuda, tps) if family == "separable"
               else (tpt.train_bwd_cuda, tpt))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(ws, *per_point, *xyzr, xyzr[0], xyzr[1], point_grads=True)
    assert all(v == 0 for v in mod.launches.values())
