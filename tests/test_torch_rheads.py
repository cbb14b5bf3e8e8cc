"""The R-heads kernel pair's entry (``ops/rheads.py``: E(R), alpha(R), b(R)
and the gate at every point) on the CPU, through its plain versions.

- The plain forward is the torch heads themselves: ``ansatz.energy`` and
  ``pallas_train.train_heads`` bit for bit, in float64 and float32, both
  sectors, with and without the alpha and beta heads.
- The plain backward is autograd through them: every weight gradient bit
  for bit, r's (which sums four heads' terms in autograd's order) to 1e-12
  in float64 and 1e-6 in float32 of the largest; a None cotangent is
  zero.
- ``psi_lap_train(..., point_grads=True)``: r's gradient through the
  kernel and the heads equals autograd of the plain composition.
- ``routing.psi_lap`` on K2 params goes through the entry, once forward and
  once backward a loss; ``psi_lap_rows`` (the quotients) never does, and
  nothing else adds to its launch counter, which ``routing.COUNTERS``
  holds apart from K1-K3's launches.
- The CUDA wrappers launch or raise, never the plain path; on a host with
  a card the kernels match the plain versions (skipped without one:
  ``chip_smoke.py`` holds them at the recipes' sizes).
"""

import pytest
import torch

from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_train as tpt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    rheads as trh
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    routing as trt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    variational as tvar

N = 333   # ragged: not a multiple of a block
HEADS = {"none": (False, False), "alpha": (True, False),
         "beta": (False, True), "both": (True, True)}
DTYPES = {"float64": torch.float64, "float32": torch.float32}
R_RTOL = {torch.float64: 1e-12, torch.float32: 1e-6}


def model(p_sym, heads, dtype, seed=4, hidden_e=8, hidden_gate=6):
    """(ModelConfig, params) of the symmetric family with the chosen heads,
    each head's output layer drawn N(0, 0.5^2) so that it shapes its
    output (the init's alpha and beta heads are flat)."""
    alpha, beta = HEADS[heads]
    mcfg = tcfg.ModelConfig(hidden=4, hidden_e=hidden_e,
                            hidden_gate=hidden_gate, hidden_alpha=5,
                            inversion_symmetry=p_sym,
                            trainable_exponent=alpha, gz=beta)
    params = tans.init_params(mcfg, seed=seed, dtype=dtype, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for name in ("alpha2", "beta2", "gate2", "eout"):
        if name in params:
            w = params[name]["w"]
            params[name]["w"] = 0.5 * torch.randn(
                w.shape, generator=gen, dtype=torch.float64).to(dtype)
    return mcfg, params


def r_values(dtype, n=N, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (0.2 + 3.8 * torch.rand(n, generator=gen,
                                   dtype=torch.float64)).to(dtype)


def cotangents(dtype, n=N, seed=9):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(n, generator=gen, dtype=torch.float64).to(dtype)
            for _ in range(4)]


def leaves_of(params):
    return [t.requires_grad_(True) for v in params.values()
            for t in v.values()]


def torch_heads(params, mcfg, r):
    """(E, alpha, b, gate) as the flat entry evaluated them before the
    kernel pair: ``ansatz.energy`` and ``train_heads``."""
    a, b, g = tpt.train_heads(params, mcfg, r)
    return tans.energy(params, r), a, b, g


@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("p_sym", [1, -1])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_values_are_the_torch_heads(dtype, p_sym, heads):
    dt = DTYPES[dtype]
    mcfg, params = model(p_sym, heads, dt)
    r = r_values(dt)
    got = trh.r_heads(params, mcfg, r)
    want = torch_heads(params, mcfg, r)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == dt and torch.equal(g, w)


@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("p_sym", [1, -1])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_gradients_are_autograd_through_the_heads(dtype, p_sym, heads):
    dt = DTYPES[dtype]
    mcfg, params = model(p_sym, heads, dt)
    leaves = leaves_of(params)
    r = r_values(dt).requires_grad_(True)
    cots = cotangents(dt)

    def grads(outs):
        loss = sum((o * c).sum() for o, c in zip(outs, cots))
        return torch.autograd.grad(loss, leaves + [r], allow_unused=True)

    got = grads(trh.r_heads(params, mcfg, r))
    want = grads(torch_heads(params, mcfg, r))
    for g, w in zip(got[:-1], want[:-1]):
        if w is None:   # a layer no head reads (the correction network)
            assert g is None or not g.any()
        else:
            assert torch.equal(g, w)
    tol = R_RTOL[dt]
    torch.testing.assert_close(got[-1], want[-1], rtol=tol,
                               atol=tol * float(want[-1].abs().max()))


@pytest.mark.parametrize("p_sym", [1, -1])
def test_none_cotangent_is_zero(p_sym):
    """The backward reads a None cotangent as zero (the fine-tune's: only E
    is trained)."""
    mcfg, params = model(p_sym, "both", torch.float64)
    ws = trh.head_weights(params, torch.float64)
    r = r_values(torch.float64)
    de, da, _, dg = cotangents(torch.float64)
    kw = dict(p_sym=p_sym, has_alpha=True, has_beta=True, r_grad=True)
    got = trh.rheads_vjp_plain(ws, r, de, da, None, dg, **kw)
    want = trh.rheads_vjp_plain(ws, r, de, da, torch.zeros_like(r), dg, **kw)
    for g, w in zip(list(got[0]) + [got[1]], list(want[0]) + [want[1]]):
        assert torch.equal(g, w)
    dws, dr = trh.rheads_vjp_plain(ws, r, None, None, None, None, **kw)
    assert all(not g.any() for g in dws) and not dr.any()
    _, dr = trh.rheads_vjp_plain(ws, r, de, None, None, None,
                                 **{**kw, "r_grad": False})
    assert dr is None


@pytest.mark.parametrize("p_sym", [1, -1])
@pytest.mark.parametrize("trained", ["e", "gate", "alpha", "beta", "r"])
def test_outputs_need_gradients_as_the_torch_heads_do(trained, p_sym):
    """An output whose inputs need no gradient is a constant, as the torch
    heads' is: with E alone trained (the fine-tune) alpha, b and the gate
    are, so K2's backward never runs; b follows alpha in the ungerade
    sector."""
    mcfg, params = model(p_sym, "both", torch.float64)
    r = r_values(torch.float64)
    if trained == "r":
        r.requires_grad_(True)
    else:
        for f in ("w", "b"):
            params[f"{trained}1"][f].requires_grad_(True)
    got = [o.requires_grad for o in trh.r_heads(params, mcfg, r)]
    want = [o.requires_grad for o in torch_heads(params, mcfg, r)]
    assert got == want


@pytest.mark.parametrize("p_sym", [1, -1])
def test_point_grads_dr_is_autograd_of_the_plain_composition(p_sym):
    """psi_lap_train(..., point_grads=True): d/dr through K2's plain adjoint
    and the heads' entry against autograd of the plain forward with the
    torch heads, and so are the params' gradients."""
    mcfg, params = model(p_sym, "both", torch.float64)
    gen = torch.Generator().manual_seed(3)
    x, y, z = (6.0 * torch.rand(N, generator=gen, dtype=torch.float64) - 3.0
               for _ in range(3))
    r = r_values(torch.float64)
    leaves = leaves_of(params)

    def objective(psi, lap, e):
        return (psi ** 2).sum() + lap.sum() + (e * psi).sum()

    xyzr = [t.clone().requires_grad_(True) for t in (x, y, z, r)]
    got = torch.autograd.grad(
        objective(*tpt.psi_lap_train(params, mcfg, *xyzr, point_grads=True)),
        xyzr + leaves, allow_unused=True)
    xyzr_w = [t.clone().requires_grad_(True) for t in (x, y, z, r)]
    e, a, b, g = torch_heads(params, mcfg, xyzr_w[3])
    psi, lap = tpt.psi_lap_train_plain(
        tpt.kernel_weights(params, mcfg, torch.float64), a, b, g, *xyzr_w,
        p_sym=p_sym)
    want = torch.autograd.grad(objective(psi, lap, e), xyzr_w + leaves,
                               allow_unused=True)
    for u, v in zip(got, want):
        if v is None:
            assert u is None or not u.any()
        else:
            torch.testing.assert_close(u, v, rtol=1e-10, atol=1e-12)


def test_bfloat16_rounds_the_float32_heads_once():
    """On bfloat16 tensors the entry computes as the bfloat16 build does:
    the float32 heads on the bfloat16 values, each output rounded once."""
    mcfg, params = model(1, "both", torch.bfloat16)
    r = r_values(torch.bfloat16)
    got = trh.r_heads(params, mcfg, r)
    p32 = {k: {f: t.float() for f, t in v.items()} for k, v in
           params.items()}
    want = torch_heads(p32, mcfg, r.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


def test_psi_lap_takes_the_entry_and_the_rows_do_not(monkeypatch):
    """routing.psi_lap on K2 params evaluates the heads through the entry
    (one forward and one backward of its plain versions for one loss and
    gradient); psi_lap_rows evaluates them once a row through
    train_heads, never through the entry; no launch is counted on the
    CPU, and the entry's counter stays out of K2's launches."""
    calls = []
    for name in ("rheads_plain", "rheads_vjp_plain"):
        real = getattr(trh, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(trh, name, spy)
    trh.reset_launches()
    cfg = tcfg.Config(model=tcfg.ModelConfig(
        hidden=4, hidden_e=8, hidden_gate=4, gz=True,
        trainable_exponent=True), dtype="float64")
    params = tans.init_params(cfg.model, seed=1, dtype=torch.float64,
                              device="cpu")
    leaves = leaves_of(params)
    r = r_values(torch.float64, n=64)
    x = torch.linspace(-2.0, 2.0, 64, dtype=torch.float64)
    psi, lap, e = trt.psi_lap(params, cfg.model, x, x.flip(0), 0.5 * x, r)
    assert calls == ["rheads_plain"]
    torch.autograd.grad(((psi - e) ** 2).sum() + lap.sum(), leaves,
                        allow_unused=True)
    # the plain backward recomputes the heads under autograd
    once = ["rheads_plain", "rheads_vjp_plain", "rheads_plain"]
    assert calls == once
    vb = tvar.dual_grid_vbatch(cfg, 3, 6, 4, device="cpu")
    loss, _ = tvar.quotient_loss(params, cfg, vb)
    torch.autograd.grad(loss, leaves, allow_unused=True)
    assert calls == once
    assert all(v == 0 for v in trh.launches.values())
    assert any(c is trh.launches for c in trt.COUNTERS)
    assert not set(trh.launches) & set(tpt.launches)


def test_weight_layout():
    """The packed weights' shapes at each set of heads, and the widths read
    back from them."""
    for heads, (alpha, beta) in HEADS.items():
        mcfg, params = model(1, heads, torch.float64, hidden_e=16,
                             hidden_gate=7)
        ws = trh.head_weights(params, torch.float64)
        widths = trh.widths(ws, alpha, beta)
        assert widths == (16, 7, 5 if alpha else 0, 5 if beta else 0)
        assert tuple(tuple(w.shape) for w in ws) == \
            trh.weight_shapes(*widths)
        assert ws[0] is params["e1"]["w"]   # the params' own leaves


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: never the plain path, and no
    launch is counted. E widths outside the kernels' (hidden=5) and rank-1
    heads past MAX_HEAD_WIDTH are refused on every device."""
    trh.reset_launches()
    mcfg, params = model(-1, "both", torch.float64)
    ws = trh.head_weights(params, torch.float64)
    r = r_values(torch.float64)
    kw = dict(p_sym=-1, has_alpha=True, has_beta=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        trh.rheads_fwd_cuda(ws, r, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        trh.rheads_bwd_cuda(ws, r, r, None, r, None, r_grad=True, **kw)
    _, p5 = model(1, "both", torch.float64, hidden_e=5)
    with pytest.raises(ValueError, match="hidden=5"):
        trh.rheads_fwd_cuda(trh.head_weights(p5, torch.float64), r, **kw)
    _, pw = model(1, "both", torch.float64,
                  hidden_gate=trh.MAX_HEAD_WIDTH + 1)
    with pytest.raises(ValueError, match="at most"):
        trh.rheads_fwd_cuda(trh.head_weights(pw, torch.float64), r, **kw)
    assert all(v == 0 for v in trh.launches.values())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernels_match_plain_on_a_card(dtype):
    """On a host with a card: the kernels against their plain versions on
    the same inputs, two backward launches bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: chip_smoke.py runs this check there")
    dt = DTYPES[dtype]
    tol = 1e-12 if dt == torch.float64 else 1e-5
    for p_sym in (1, -1):
        mcfg, params = model(p_sym, "both", dt, hidden_e=32, hidden_gate=10)
        ws = trh.head_weights(params, dt)
        r = r_values(dt, n=10_000)
        cots = cotangents(dt, n=10_000)
        kw = dict(p_sym=p_sym, has_alpha=True, has_beta=True)
        want = trh.rheads_plain(ws, r, **kw)
        dws_w, dr_w = trh.rheads_vjp_plain(ws, r, *cots, r_grad=True, **kw)
        wc = [w.cuda() for w in ws]
        got = trh.rheads_fwd_cuda(wc, r.cuda(), **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=tol, atol=tol)
        args = (wc, r.cuda(), *(c.cuda() for c in cots))
        dws, dr = trh.rheads_bwd_cuda(*args, r_grad=True, **kw)
        dws2, dr2 = trh.rheads_bwd_cuda(*args, r_grad=True, **kw)
        for g, g2, w in zip(list(dws) + [dr], list(dws2) + [dr2],
                            list(dws_w) + [dr_w]):
            assert torch.equal(g, g2)
            scale = float(w.abs().max())
            torch.testing.assert_close(g.cpu(), w, rtol=100 * tol,
                                       atol=100 * tol * max(scale, 1.0))
