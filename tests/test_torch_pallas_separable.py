"""The port's fused separable kernel module (ops/pallas_separable.py) on the
CPU: the plain forward and the plain explicit adjoint — the arithmetic the
CUDA kernels transliterate — against the JAX package's Pallas kernel (run in
interpret mode, at H = 4 as its own tests do) and against torch autograd.

Tolerances (float64): psi rtol 1e-12, lap rtol 1e-10 (tests/
test_pallas_separable.py); adjoint rtol 1e-8 with an absolute floor of
1e-11 times the tensor's scale (weight gradients are sums over the points,
taken in another order). The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
from pinn_for_quantum_wavefunction_surfaces_tpu.ops import \
    pallas_separable as jps
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_separable as tps

from test_torch_separable import (as_t, jax_model,  # noqa: F401
                                  no_jax_cache_writes, points)

N = 1100   # ragged: not a multiple of any tile or block


def kernel_inputs(params, tm, pts):
    """(12 weights, a, b) of the port from numpy params, as the training
    path builds them."""
    tp = tans.from_jax_params(params, device="cpu")
    r = as_t(pts[3])[0]
    a = tans.orbital_exponent(tp, r)
    b = tans.gz_exponent(tp, r, tm.inversion_symmetry, a)
    return tps.kernel_weights(tp, torch.float64), a, b


def assert_grads_close(got, want, rtol=1e-8):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=1e-11 * np.abs(w).max())


@pytest.mark.parametrize("p_sym", [1, -1])
def test_plain_forward_matches_pallas_interpret(p_sym):
    mcfg, tm, params = jax_model(p_sym, hidden=4)
    pts = points(N)
    psi_j, lap_j, e_j = jax.jit(
        jps.psi_lap_train_separable, static_argnums=(1,),
        static_argnames=("interpret",))(params, mcfg, *pts, interpret=True)
    tp = tans.from_jax_params(params, device="cpu")
    psi_t, lap_t, e_t = tps.psi_lap_train_separable(tp, tm, *as_t(*pts))
    np.testing.assert_allclose(psi_t.detach().numpy(), np.asarray(psi_j),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(lap_t.detach().numpy(), np.asarray(lap_j),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(e_t.detach().numpy(), np.asarray(e_j),
                               rtol=1e-14)


@pytest.mark.parametrize("hidden", [4, 16])
@pytest.mark.parametrize("p_sym", [1, -1])
def test_plain_vjp_matches_autograd(hidden, p_sym):
    _, tm, params = jax_model(p_sym, hidden)
    pts = points(N)
    ws, a, b = kernel_inputs(params, tm, pts)
    xyzr = as_t(*pts)
    rng = np.random.default_rng(7)
    dpsi, dlap = as_t(rng.normal(size=N), rng.normal(size=N))
    kw = dict(p_sym=p_sym)
    ws_g = [w.clone().requires_grad_(True) for w in ws]
    a_g, b_g = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    psi, lap = tps.psi_lap_separable_plain(ws_g, a_g, b_g, *xyzr, **kw)
    want = torch.autograd.grad((psi * dpsi).sum() + (lap * dlap).sum(),
                               ws_g + [a_g, b_g])
    dws, da, db = tps.psi_lap_separable_vjp_plain(ws, a, b, *xyzr, dpsi,
                                                  dlap, **kw)
    assert_grads_close([t.numpy() for t in list(dws) + [da, db]],
                       [t.numpy() for t in want])


@pytest.mark.parametrize("p_sym", [1, -1])
def test_wrapper_gradients_match_jax_wrapper_vjp(p_sym):
    """The plain explicit adjoint against jax.vjp of the JAX package's
    psi_lap_train_separable (its Pallas backward kernel in interpret mode):
    cotangents of every parameter, through the R-only heads (autograd) and
    the kernel's adjoint (psi_lap_separable_vjp_plain on the CPU)."""
    mcfg, tm, params = jax_model(p_sym, hidden=4)
    pts = points(N)
    rng = np.random.default_rng(9)
    dpsi, dlap = rng.normal(size=N), rng.normal(size=N)

    @jax.jit
    def vjp(p):
        def f(q):
            psi, lap, _ = jps.psi_lap_train_separable(q, mcfg, *pts,
                                                      interpret=True)
            return psi, lap
        _, f_vjp = jax.vjp(f, p)
        return f_vjp((jnp.asarray(dpsi), jnp.asarray(dlap)))[0]

    want = vjp(jax.tree.map(jnp.asarray, params))
    tp = tans.from_jax_params(params, device="cpu")
    keys = [(k, f) for k in sorted(tp) for f in sorted(tp[k])]
    leaves = [tp[k][f].requires_grad_(True) for k, f in keys]
    psi, lap, _ = tps.psi_lap_train_separable(tp, tm, *as_t(*pts))
    dp, dl = as_t(dpsi, dlap)
    got = torch.autograd.grad((psi * dp).sum() + (lap * dl).sum(), leaves,
                              allow_unused=True)
    got = [np.zeros(tuple(t.shape)) if g is None else g.numpy()
           for g, t in zip(got, leaves)]
    assert_grads_close(got, [want[k][f] for k, f in keys])


def test_autograd_function_composes_with_heads():
    """Gradients of a loss through SeparableKernel (plain adjoint on the
    CPU) plus the R-only heads == torch autograd through the plain
    forward-Laplacian ansatz, for every parameter."""
    _, tm, params = jax_model(1, hidden=16)
    x, y, z, r = as_t(*points(N))

    def loss(psi, lap, e):
        return (psi ** 2).sum() + (psi * lap).sum() + (e ** 2).sum()

    tp1 = tans.from_jax_params(params, device="cpu")
    tp2 = tans.from_jax_params(params, device="cpu")
    leaves1 = [t.requires_grad_(True) for v in tp1.values()
               for t in v.values()]
    leaves2 = [t.requires_grad_(True) for v in tp2.values()
               for t in v.values()]
    g1 = torch.autograd.grad(
        loss(*tps.psi_lap_train_separable(tp1, tm, x, y, z, r)), leaves1)
    s, e = tans.psi_fwdlap(tp2, tm, x, y, z, r)
    g2 = torch.autograd.grad(loss(s.v[..., 0], s.l[..., 0], e), leaves2)
    assert_grads_close([t.numpy() for t in g1], [t.numpy() for t in g2])


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the request is valid here")
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.device import \
        resolve_device
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        variational
    tm = tcfg.ModelConfig(arch="separable")
    cfg = tcfg.Config(model=tm, dtype="float64")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tans.init_params(tm, seed=0, dtype="float64")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        variational.polish_spheroidal(None, cfg, n_r=1, n_xi=6, n_eta=4,
                                      steps=1)
    _, _, params = jax_model()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tans.from_jax_params(params)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: never the plain path."""
    _, tm, params = jax_model(1, hidden=16)
    pts = points(64)
    ws, a, b = kernel_inputs(params, tm, pts)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tps.separable_fwd_cuda(ws, a, b, *as_t(*pts))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tps.separable_bwd_cuda(ws, a, b, *as_t(*pts), a, b)
    _, tm5, p5 = jax_model(1, hidden=5)
    ws5, a5, b5 = kernel_inputs(p5, tm5, pts)
    with pytest.raises(ValueError, match="hidden=5"):
        tps.separable_fwd_cuda(ws5, a5, b5, *as_t(*pts))
    assert tps.launches == {"separable_fwd": 0, "separable_bwd": 0,
                            "separable_bwd_pg": 0}


@pytest.mark.parametrize("family", ["xi_node", "eta_node", "m_abs",
                                    "symmetric"])
def test_unported_families_raise(family):
    # the symmetric family runs in the port (ops/pallas_train.py), but not
    # its R-input models, nor through the separable kernel
    kw = {"xi_node": dict(xi_node=True), "eta_node": dict(eta_node=True),
          "m_abs": dict(m_abs=1), "symmetric": dict(r_input=True)}[family]
    arch = "symmetric" if family == "symmetric" else "separable"
    mcfg = pqs.ModelConfig(arch=arch, hidden=4, **kw)
    params = jax.tree.map(np.asarray, jans.init_params(
        jax.random.PRNGKey(0), mcfg, jnp.float64))
    tm = tcfg.ModelConfig(arch=arch, hidden=4, **kw)
    tp = tans.from_jax_params(params, device="cpu")
    x = torch.ones(8, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        tps.psi_lap_train_separable(tp, tm, x, x, x, x)
    with pytest.raises(NotImplementedError):
        tans.psi_fwdlap(tp, tm, x, x, x, x)
    with pytest.raises(NotImplementedError):
        tans.init_params(tm, seed=0, device="cpu")


@pytest.mark.parametrize("hidden", tps.SUPPORTED_HIDDEN)
def test_grid_sizing(hidden):
    """The kernels' tiles and K1-bwd's grid (rows of partial weight
    gradients): fixed by n and H alone, capped at a multiple of the SM
    count, and the blocks' strided walks cover every tile exactly once."""
    per = tps.points_per_tile(hidden)
    assert per * min(8, hidden) == tps.THREADS
    cap = tps.GRID_BLOCKS_PER_SM * tps.N_SM
    assert [tps.grid_blocks(n, hidden) for n in (0, 1, per, per + 1)] == \
        [1, 1, 1, 2]
    for n in (N, 9216, 164_502):   # ragged; a make evaluate quotient; flagship
        tiles = tps.n_tiles(n, hidden)
        assert (tiles - 1) * per < n <= tiles * per
        grid = tps.grid_blocks(n, hidden)
        assert grid == min(tiles, cap)
        walked = sorted(t for blk in range(grid)
                        for t in range(blk, tiles, grid))
        assert walked == list(range(tiles))
    assert tps.grid_blocks(164_502, hidden) == cap


def test_pad_point_adds_exactly_zero():
    """Lanes past n evaluate the pad point (1, 1, 1; R = 1, a = b = 1)
    with zero cotangents: every cotangent they produce is exactly 0, so the
    kernels' padded tiles change no sum."""
    _, tm, params = jax_model(1, hidden=16)
    ws, _, _ = kernel_inputs(params, tm, points(8))
    one = torch.ones(8, dtype=torch.float64)
    zero = torch.zeros(8, dtype=torch.float64)
    psi, lap = tps.psi_lap_separable_plain(ws, one, one, one, one, one, one)
    assert bool(torch.isfinite(psi).all() and torch.isfinite(lap).all())
    dws, da, db = tps.psi_lap_separable_vjp_plain(ws, one, one, one, one, one,
                                                  one, zero, zero)
    for g in list(dws) + [da, db]:
        assert bool((g == 0).all())


def test_kernel_weights_layout():
    """Weights cast to the point dtype, biases reshaped to (1, H)."""
    _, _, params = jax_model(1, hidden=8)
    tp = tans.from_jax_params(params, device="cpu")
    ws = tps.kernel_weights(tp, torch.float32)
    assert [tuple(w.shape) for w in ws] == list(tps.weight_shapes(8))
    assert all(w.dtype == torch.float32 for w in ws)
    np.testing.assert_array_equal(ws[1].numpy()[0],
                                  params["lam1"]["b"].astype(np.float32))
