"""The port's fused symmetric-family kernel module (ops/pallas_train.py, K2)
on the CPU: the plain forward and the plain explicit adjoint — the
arithmetic the CUDA kernels transliterate — against the JAX package's
Pallas kernel (interpret mode, at H <= 8 as its own tests run the backward)
and XLA forward-Laplacian path, and against torch autograd.

Tolerances (float64, those of tests/test_pallas_train.py): psi rtol 1e-12
(atol 1e-14: the ungerade psi cancels near the mid-plane), lap rtol 1e-11
with atol 1e-12, gradients rtol 1e-8 with atol 1e-12. The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
from pinn_for_quantum_wavefunction_surfaces_tpu.ops import pallas_train as jpt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_train as tpt

from test_torch_separable import (as_t, load_artifact,  # noqa: F401
                                  no_jax_cache_writes, points)

N = 1100   # ragged: not a multiple of any tile or block


def sym_model(p_sym=1, gz=False, alpha=False, hidden=4, seed=0):
    """JAX-drawn symmetric params with the zero-initialised alpha/beta head
    weights knocked off zero (as tests/test_pallas_train.py does), in
    numpy; with the JAX and port configs."""
    kw = dict(inversion_symmetry=p_sym, gz=gz, trainable_exponent=alpha,
              hidden=hidden)
    mcfg = pqs.ModelConfig(**kw)
    params = jans.init_params(jax.random.PRNGKey(seed), mcfg, jnp.float64)
    if alpha:
        params["alpha2"]["w"] = params["alpha2"]["w"] + 0.3
    if gz:
        params["beta2"]["w"] = params["beta2"]["w"] + 0.2
    return mcfg, tcfg.ModelConfig(**kw), jax.tree.map(np.asarray, params)


def kernel_inputs(params, tm, r):
    """(6 weights, a, b, g) of the port from numpy params, as the training
    path builds them."""
    tp = tans.from_jax_params(params, device="cpu")
    r = as_t(r)[0]
    a = (tans.orbital_exponent(tp, r) if "alpha1" in tp
         else torch.ones_like(r))
    b = tans.gz_exponent(tp, r, tm.inversion_symmetry, a)
    g = tans.gate(tp, r)
    return (tpt.kernel_weights(tp, tm, torch.float64),
            *(t.detach() for t in (a, b, g)))


def assert_grads_close(got, want, rtol=1e-8, atol=1e-12):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


_PSI_LAP = jax.jit(jpt.psi_lap_train, static_argnums=(1,),
                   static_argnames=("interpret", "point_grads"))


@pytest.mark.parametrize("p_sym,gz,alpha,hidden", [
    (1, False, False, 8), (-1, False, False, 4), (1, True, True, 8),
    (-1, True, True, 4), (1, False, True, 4), (-1, True, False, 8),
])
def test_plain_forward_matches_pallas_interpret_and_fwdlap(p_sym, gz, alpha,
                                                           hidden):
    mcfg, tm, params = sym_model(p_sym, gz, alpha, hidden)
    pts = points(N)
    psi_j, lap_j, e_j = _PSI_LAP(params, mcfg, *pts, interpret=True)
    s, _ = jans.psi_fwdlap(params, mcfg, *pts)
    tp = tans.from_jax_params(params, device="cpu")
    psi_t, lap_t, e_t = tpt.psi_lap_train(tp, tm, *as_t(*pts))
    psi_t, lap_t = psi_t.detach().numpy(), lap_t.detach().numpy()
    for want_psi, want_lap in ((psi_j, lap_j), (s.v[..., 0], s.l[..., 0])):
        np.testing.assert_allclose(psi_t, np.asarray(want_psi), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(lap_t, np.asarray(want_lap), rtol=1e-11,
                                   atol=1e-12)
    np.testing.assert_allclose(e_t.detach().numpy(), np.asarray(e_j),
                               rtol=1e-14)
    # the value-only ansatz agrees with the fused forward
    pv, _ = tans.psi(tp, tm, *as_t(*pts))
    np.testing.assert_allclose(pv.numpy(), psi_t, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("p_sym", [1, -1])
def test_plain_vjp_matches_pallas_vjp_and_autograd(p_sym):
    """psi_lap_train_vjp_plain against torch autograd of the plain forward
    and against jax.vjp of the JAX kernel (its Pallas backward in interpret
    mode) in (weights, a, b, g). In the ungerade sector the output bias is
    the constant 0, so params["out"]["b"] gets no gradient (as in JAX)."""
    mcfg, tm, params = sym_model(p_sym, True, True, hidden=4)
    pts = points(N)
    ws, a, b, g = kernel_inputs(params, tm, pts[3])
    xyzr = as_t(*pts)
    rng = np.random.default_rng(7)
    dpsi, dlap = rng.normal(size=N), rng.normal(size=N)
    dp, dl = as_t(dpsi, dlap)
    kw = dict(p_sym=p_sym)
    dws, da, db, dg = tpt.psi_lap_train_vjp_plain(ws, a, b, g, *xyzr, dp,
                                                  dl, **kw)
    got = [t.numpy() for t in list(dws) + [da, db, dg]]

    leaves = [t.clone().requires_grad_(True) for t in list(ws) + [a, b, g]]
    psi, lap = tpt.psi_lap_train_plain(leaves[:6], *leaves[6:], *xyzr, **kw)
    want = torch.autograd.grad((psi * dp).sum() + (lap * dl).sum(), leaves)
    assert_grads_close(got, [t.numpy() for t in want])

    fused = jpt.make_fused_psi_lap(4, p_sym, 0.0, 0.0, True, False)

    @jax.jit
    def vjp(args, cts):
        _, f_vjp = jax.vjp(lambda *q: fused(*q, *pts), *args)
        return f_vjp(cts)

    want_j = vjp(tuple(jnp.asarray(t.numpy()) for t in list(ws) + [a, b, g]),
                 (jnp.asarray(dpsi), jnp.asarray(dlap)))
    assert_grads_close(got, [np.asarray(t) for t in want_j])

    # through the wrapper: params["out"]["b"] gets no gradient for P = -1
    tp = tans.from_jax_params(params, device="cpu")
    wrt = [tp["out"]["b"].requires_grad_(True),
           tp["out"]["w"].requires_grad_(True)]
    psi_w, lap_w, _ = tpt.psi_lap_train(tp, tm, *xyzr)
    g_ob, g_ow = torch.autograd.grad((psi_w * dp).sum() + (lap_w * dl).sum(),
                                     wrt, allow_unused=True)
    assert (g_ob is None) == (p_sym < 0) and g_ow is not None


def test_autograd_function_composes_with_heads():
    """Gradients of a loss through TrainKernel (plain adjoint on the CPU)
    plus the R-only heads == torch autograd through the plain forward with
    the heads, for every parameter, at the paper width H = 16."""
    _, tm, params = sym_model(1, True, True, hidden=16)
    x, y, z, r = as_t(*points(N))

    def loss(psi, lap, e):
        return (psi ** 2).sum() + (psi * lap).sum() + (e ** 2).sum()

    grads = []
    for fused in (True, False):
        tp = tans.from_jax_params(params, device="cpu")
        leaves = [t.requires_grad_(True) for v in tp.values()
                  for t in v.values()]
        if fused:
            out = tpt.psi_lap_train(tp, tm, x, y, z, r)
        else:
            a = tans.orbital_exponent(tp, r)
            b = tans.gz_exponent(tp, r, 1, a)
            out = tpt.psi_lap_train_plain(
                tpt.kernel_weights(tp, tm, torch.float64), a, b,
                tans.gate(tp, r), x, y, z, r) + (tans.energy(tp, r),)
        grads.append(torch.autograd.grad(loss(*out), leaves))
    assert_grads_close([t.numpy() for t in grads[0]],
                       [t.numpy() for t in grads[1]], rtol=1e-12, atol=0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: never the plain path."""
    _, tm, params = sym_model(1, True, True, hidden=16)
    pts = points(64)
    ws, a, b, g = kernel_inputs(params, tm, pts[3])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpt.train_fwd_cuda(ws, a, b, g, *as_t(*pts))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpt.train_bwd_cuda(ws, a, b, g, *as_t(*pts), a, b)
    _, tm5, p5 = sym_model(1, hidden=5)
    ws5, a5, b5, g5 = kernel_inputs(p5, tm5, pts[3])
    with pytest.raises(ValueError, match="hidden=5"):
        tpt.train_fwd_cuda(ws5, a5, b5, g5, *as_t(*pts))
    assert tpt.launches == {"train_fwd": 0, "train_bwd": 0,
                            "train_bwd_pg": 0}


def test_rejects_r_input_minimal_and_separable():
    x = torch.ones(8, dtype=torch.float64)
    for kw in (dict(r_input=True), dict(arch="minimal")):
        mcfg = pqs.ModelConfig(hidden=4, **kw)
        params = jax.tree.map(np.asarray, jans.init_params(
            jax.random.PRNGKey(0), mcfg, jnp.float64))
        tm = tcfg.ModelConfig(hidden=4, **kw)
        with pytest.raises(NotImplementedError):
            tpt.psi_lap_train(tans.from_jax_params(params, device="cpu"), tm,
                              x, x, x, x)
        with pytest.raises(NotImplementedError):
            tans.init_params(tm, seed=0, device="cpu")
    sep = tcfg.ModelConfig(arch="separable", hidden=4)
    with pytest.raises(NotImplementedError):
        tpt.psi_lap_train(tans.init_params(sep, seed=0, device="cpu"), sep,
                          x, x, x, x)


@pytest.mark.parametrize("name,p_sym", [("flagship.npz", 1),
                                        ("ungerade_2psu.npz", -1)])
def test_shipped_symmetric_artifacts_match_jax(name, p_sym):
    """The two shipped symmetric checkpoints (GZ + alpha) through the port's
    fused forward == the JAX fwdlap path, on a wider domain."""
    params = load_artifact(name)
    kw = dict(inversion_symmetry=p_sym, gz=True, trainable_exponent=True)
    pts = points(n=2000, seed=4, lo=-8, hi=8, r_lo=0.2, r_hi=4.0)
    s, e = jans.psi_fwdlap(params, pqs.ModelConfig(**kw), *pts)
    psi, lap, et = tpt.psi_lap_train(
        tans.from_jax_params(params, device="cpu"), tcfg.ModelConfig(**kw),
        *as_t(*pts))
    np.testing.assert_allclose(psi.numpy(), np.asarray(s.v[..., 0]),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(lap.numpy(), np.asarray(s.l[..., 0]),
                               rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(et.numpy(), np.asarray(e), rtol=1e-14)


@pytest.mark.parametrize("hidden", [4, 8, 16, 32])
def test_grid_sizing(hidden):
    """The kernels' tiles and K2-bwd's grid (rows of partial weight
    gradients), in both types: fixed by n, H and the dtype alone, capped at
    a multiple of the SM count, and the blocks' strided walks cover every
    tile exactly once."""
    for dtype in (torch.float64, torch.float32):
        per = tpt.points_per_tile(hidden, dtype)
        if dtype == torch.float64:
            # a block of 256 threads: 2 branches x per points, 256 // (2 per)
            # threads a (branch, point) pair, whole units each
            assert 256 % (2 * per) == 0 and hidden % (256 // (2 * per)) == 0
        else:
            assert per == tpt.threads(dtype)
        cap = tpt.GRID_BLOCKS_PER_SM[dtype] * tpt.N_SM
        assert [tpt.n_tiles(n, hidden, dtype) for n in (0, 1, per, per + 1)] \
            == [0, 1, 1, 2]
        assert [tpt.grid_blocks(n, hidden, dtype)
                for n in (0, 1, per, per + 1)] == [1, 1, 1, 2]
        for n in (N, 9216, 100_000):   # ragged; a quotient; make train
            tiles = tpt.n_tiles(n, hidden, dtype)
            assert (tiles - 1) * per < n <= tiles * per
            grid = tpt.grid_blocks(n, hidden, dtype)
            assert grid == min(tiles, cap)
            walked = sorted(t for blk in range(grid)
                            for t in range(blk, tiles, grid))
            assert walked == list(range(tiles))
        assert tpt.grid_blocks(100_000, hidden, dtype) == cap


@pytest.mark.parametrize("p_sym", [1, -1])
def test_pad_point_adds_exactly_zero(p_sym):
    """Lanes past n evaluate the pad point (1, 1, 1; R = 1, a = b = g = 1)
    with zero cotangents: every cotangent they produce is exactly 0, so the
    kernels' padded tiles change no sum."""
    _, tm, params = sym_model(p_sym, True, True, hidden=16)
    ws, _, _, _ = kernel_inputs(params, tm, points(8)[3])
    one = torch.ones(8, dtype=torch.float64)
    zero = torch.zeros(8, dtype=torch.float64)
    kw = dict(p_sym=p_sym)
    psi, lap = tpt.psi_lap_train_plain(ws, one, one, one, one, one, one,
                                       one, **kw)
    assert bool(torch.isfinite(psi).all() and torch.isfinite(lap).all())
    dws, da, db, dg = tpt.psi_lap_train_vjp_plain(ws, one, one, one, one, one,
                                                  one, one, zero, zero, **kw)
    for g in list(dws) + [da, db, dg]:
        assert bool((g == 0).all())
