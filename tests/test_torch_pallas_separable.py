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
    _cuda
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_separable as tps
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_train as tpt

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
    assert tps.launches == {k + sfx: 0 for sfx in ("", "_bf16") for k in (
        "separable_fwd", "separable_bwd", "separable_bwd_pg",
        "separable_fwd_ex", "separable_bwd_ex")}


@pytest.mark.parametrize("family", ["xi_node", "eta_node", "m_abs",
                                    "symmetric"])
def test_unported_families_raise(family):
    """The separable kernel carries the node factors and m_abs (its factor
    epilogue) and refuses only their point gradients, which no recipe
    takes, on every device; the symmetric family (here an R-input model)
    never goes through it. The families' fwdlap path and init run in the
    port, and K1's CPU path equals the fwdlap pass."""
    kw = {"xi_node": dict(xi_node=True), "eta_node": dict(eta_node=True),
          "m_abs": dict(m_abs=1), "symmetric": dict(r_input=True)}[family]
    arch = "symmetric" if family == "symmetric" else "separable"
    mcfg = pqs.ModelConfig(arch=arch, hidden=4, **kw)
    params = jax.tree.map(np.asarray, jans.init_params(
        jax.random.PRNGKey(0), mcfg, jnp.float64))
    tm = tcfg.ModelConfig(arch=arch, hidden=4, **kw)
    tp = tans.from_jax_params(params, device="cpu")
    x = torch.ones(8, dtype=torch.float64)
    s, _ = tans.psi_fwdlap(tp, tm, x, x, x, x)
    assert bool(torch.isfinite(s.l).all())
    if family == "symmetric":
        with pytest.raises(NotImplementedError):
            tps.psi_lap_train_separable(tp, tm, x, x, x, x)
    else:
        with pytest.raises(NotImplementedError, match="psi_fwdlap"):
            tps.psi_lap_train_separable(tp, tm, x, x, x, x,
                                        point_grads=True)
        pts = as_t(*points(32))
        psi, lap, _ = tps.psi_lap_train_separable(tp, tm, *pts)
        s, _ = tans.psi_fwdlap(tp, tm, *pts)
        np.testing.assert_allclose(psi.detach().numpy(),
                                   s.v[..., 0].detach().numpy(), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(lap.detach().numpy(),
                                   s.l[..., 0].detach().numpy(), rtol=1e-10,
                                   atol=1e-12)
    assert sorted(tans.init_params(tm, seed=0, device="cpu")) == \
        sorted(params)


# kernel x type x width; K1's float64 cases keep their ids (the width
# alone), its float32 and bfloat16 ones theirs
GRID_CASES = [pytest.param(tps, h, torch.float64, id=str(h))
              for h in _cuda.SUPPORTED_HIDDEN] + [
    pytest.param(tps, h, dt, id=f"{str(dt)[6:]}-{h}")
    for dt in (torch.float32, torch.bfloat16)
    for h in _cuda.SUPPORTED_HIDDEN] + [
    pytest.param(tpt, h, dt, id=f"train-{str(dt)[6:]}-{h}")
    for dt in (torch.float64, torch.float32, torch.bfloat16)
    for h in _cuda.SUPPORTED_HIDDEN]
# the points a launch takes in each benchmark cell: the flagship polish's
# padded dual grid, the 4fpiu polish's, the 80^3 scoring grid's slabs, and
# make train's batch
CELL_SIZES = (164_502, 284_310, 1_048_576, 100_000)


@pytest.mark.parametrize("mod, hidden, dtype", GRID_CASES)
def test_grid_sizing(mod, hidden, dtype):
    """K1's and K2's tiles (each wrapper's ``points_per_tile``) and their
    backward grids (rows of partial weight gradients, ``_cuda``): fixed by
    n, H and the type alone, capped at a multiple of the SM count, and the
    blocks' strided walks cover every tile exactly once. Float64 runs
    blocks of 256 threads on tiles (K1: min(8, H) threads a point; K2: two
    branches a point, whole units a thread); float32 and bfloat16 one
    thread a point, 128 a block. Every cell's launch is one full wave."""
    per = mod.points_per_tile(hidden, dtype)
    threads = _cuda.threads(dtype)
    if dtype != torch.float64:
        assert per == 128 == threads
    elif mod is tps:
        assert per * min(8, hidden) == 256 == threads
    else:
        assert threads % (2 * per) == 0
        assert hidden % (threads // (2 * per)) == 0
    cap = _cuda.GRID_BLOCKS_PER_SM[dtype] * _cuda.N_SM
    assert cap == (2 if dtype == torch.float64 else 3) * 132
    assert [_cuda.n_tiles(n, per) for n in (0, 1, per, per + 1)] == \
        [0, 1, 1, 2]
    assert [_cuda.grid_blocks(n, per, dtype)
            for n in (0, 1, per, per + 1)] == [1, 1, 1, 2]
    for n in (N, 9216) + CELL_SIZES:
        tiles = _cuda.n_tiles(n, per)
        assert (tiles - 1) * per < n <= tiles * per
        grid = _cuda.grid_blocks(n, per, dtype)
        assert grid == min(tiles, cap)
        walked = sorted(t for blk in range(grid)
                        for t in range(blk, tiles, grid))
        assert walked == list(range(tiles))
    assert [_cuda.grid_blocks(n, per, dtype) for n in CELL_SIZES] == \
        [cap] * len(CELL_SIZES)


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


@pytest.mark.parametrize("hidden", tps.SUPPORTED_HIDDEN)
def test_packed_rows_are_16_byte_aligned(hidden):
    """The float32 and bfloat16 kernels read w2's rows, b2 and ow as 16-byte
    (four-float) vectors from the weights they stage at a stride of the
    packed MLP's size rounded up to four floats (csrc/separable.cuh WSP):
    in the packed order (``_cuda.pack`` of the 12 weights) each of those
    starts on a multiple of four floats in both MLPs, and each w2 row is
    four-float aligned too."""
    sizes = [int(np.prod(s)) for s in tps.weight_shapes(hidden)]
    offsets = np.cumsum([0] + sizes)
    mlp = sum(sizes[:6])
    wsp = (mlp + 3) // 4 * 4
    assert mlp == hidden * hidden + 5 * hidden + 1
    for m in (0, 1):
        w2, b2, ow = (int(offsets[6 * m + k]) - m * mlp for k in (2, 3, 4))
        for off in (w2, b2, ow) + tuple(w2 + i * hidden
                                        for i in range(hidden)):
            assert (m * wsp + off) % 4 == 0
    ws = [torch.arange(n, dtype=torch.float32).reshape(s) + 1000.0 * k
          for k, (n, s) in enumerate(zip(sizes, tps.weight_shapes(hidden)))]
    packed = _cuda.pack(ws)
    assert packed.numel() == 2 * mlp
    for k, w in enumerate(ws):
        np.testing.assert_array_equal(
            packed[offsets[k]:offsets[k + 1]].numpy(), w.reshape(-1).numpy())
