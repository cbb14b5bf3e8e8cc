"""bfloat16 in the PyTorch port against the JAX package, on the CPU.

bfloat16 is a compute type, as in the JAX package: params, batches and
grids are cast to it and every operation rounds to it; the residual
trainer's best loss and the histories stay in float32 at least. Here, with
no card, the kernels' routes take their plain versions (their bfloat16
builds run on the card only: ``chip_smoke.py`` phase 23). Both packages get
the same numpy-seeded inputs and the same JAX-drawn params, and the JAX
side runs its default ``kernel="xla"`` route (its Pallas interpret route
takes minutes a step in bfloat16).

Tolerances, in bfloat16 units (unit roundoff u = 2^-8 = 3.9e-3):
- where the two packages round alike (the conversion of params, the
  separable family's forward-Laplacian pass at its init) they agree bit
  for bit;
- elsewhere each package rounds at other places, so the port's normwise
  error against the float64 value may be at most 1.5 x JAX's own bfloat16
  error + 1e-3 (``BF16_ERR``), and the port lies within 2e-2 of JAX's
  bfloat16 value, normwise (``BF16_GAP``: about five units), or nearer the
  float64 value than JAX's (``assert_bf16_close``). torch runs on one
  thread (see test_torch_excited.py).

The kernels' routes on bfloat16 CPU tensors compute as the bfloat16 builds
do (the plain version's float32 arithmetic, each output rounded once:
``_cuda.as_built``), and the quotients' pointwise products and sums
run in float32 (``variational._work``), as XLA's fusions do."""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.io import checkpoint as jckpt
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
from pinn_for_quantum_wavefunction_surfaces_tpu.ops import sampling as jsam
from pinn_for_quantum_wavefunction_surfaces_tpu.training import engine as jeng
from pinn_for_quantum_wavefunction_surfaces_tpu.training import losses as jlo
from pinn_for_quantum_wavefunction_surfaces_tpu.training import \
    variational as jvar
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import cli
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import device as tdev
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import _cuda
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_residual as tpr
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_separable as tps
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_train as tpt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    routing as trt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    sampling as tsam
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    engine as teng
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    losses as tlo
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    variational as tvar

from test_torch_excited import one_torch_thread, spy_on  # noqa: F401
from test_torch_families import jax_params
from test_torch_sampling_losses import port_cfg
from test_torch_separable import (ARTIFACTS, load_artifact,  # noqa: F401
                                  no_jax_cache_writes, points)

BF = torch.bfloat16
JBF = jnp.bfloat16
BF16_ERR, BF16_FLOOR, BF16_GAP = 1.5, 1e-3, 2e-2

# the families of psi_fwdlap: ModelConfig fields, and the route that
# ops.routing.psi_lap takes on the CPU
FAMILIES = {
    "separable": (dict(arch="separable"), "psi_lap_separable_plain"),
    "symmetric_gz_alpha": (dict(gz=True, trainable_exponent=True),
                           "psi_lap_train_plain"),
    "symmetric_reference_parity": (dict(), "psi_lap_train_plain"),
    "minimal": (dict(arch="minimal"), "psi_fwdlap"),
    "symmetric_r_input": (dict(r_input=True), "psi_fwdlap"),
}


def to_bf16(tree):
    """A numpy params tree as the JAX CLI casts it: ml_dtypes bfloat16."""
    return jax.tree.map(lambda a: np.asarray(a, ml_dtypes.bfloat16), tree)


def bits(a) -> np.ndarray:
    """The bit patterns of a bfloat16 array (numpy, JAX or torch)."""
    if isinstance(a, torch.Tensor):
        return a.detach().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float64).numpy()
    return np.asarray(a, np.float64)


def normwise(got, want) -> float:
    got, want = f64(got), f64(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def assert_bf16_close(port, jax_bf16, truth, label=""):
    """The port's bfloat16 value against the float64 truth at most
    BF16_ERR x JAX's own error + BF16_FLOOR, and within BF16_GAP of JAX's
    bfloat16 value (both normwise) unless the port is the closer of the
    two to the truth: JAX's bfloat16 quotients and gradients are up to 10%
    off float64 in places, and a port nearer the truth cannot then lie
    within BF16_GAP of them."""
    e_port, e_jax = normwise(port, truth), normwise(jax_bf16, truth)
    gap = normwise(port, jax_bf16)
    assert e_port <= BF16_ERR * e_jax + BF16_FLOOR, (label, e_port, e_jax)
    assert gap <= BF16_GAP or e_port < e_jax, (label, gap, e_port, e_jax)


def bf16_points(n=300, seed=1):
    """Seeded points in float64, rounded to bfloat16 (the inputs both
    packages get)."""
    return [np.asarray(np.asarray(a, ml_dtypes.bfloat16), np.float64)
            for a in points(n, seed=seed)]


# ---------------------------------------------------------------------------
# 1. params across packages


ARTIFACT_NPZ = sorted(os.path.basename(p) for p in
                      glob.glob(os.path.join(ARTIFACTS, "*.npz")))


@pytest.mark.parametrize("name", ARTIFACT_NPZ)
def test_params_convert_like_ml_dtypes(name):
    """Every shipped artifact's params to bfloat16 through
    ``from_jax_params`` and ``cli._load_as`` equal, bit for bit, the JAX
    CLI's ``np.asarray(a, ml_dtypes.bfloat16)``."""
    path = os.path.join(ARTIFACTS, name)
    tree, _ = jckpt.load_params(path)
    tree = tree.get("params", tree)
    want = to_bf16(tree)
    for got in (tans.from_jax_params(tree, dtype="bfloat16", device="cpu"),
                cli._load_as(path, "bfloat16")):
        assert sorted(got) == sorted(want)
        for k in want:
            for f in want[k]:
                assert got[k][f].dtype == BF
                np.testing.assert_array_equal(bits(got[k][f]),
                                              bits(want[k][f]),
                                              err_msg=f"{name} {k}/{f}")


def test_float64_rounds_to_bfloat16_through_float32_in_both():
    """Above a float32-representable midpoint of two bfloat16 values by
    less than float32 resolves, a float64 value rounds down through float32
    and up when rounded once. ml_dtypes (the JAX CLI's cast) and torch both
    round through float32: the same bits, which is what the port needs."""
    rng = np.random.default_rng(0)
    x = np.concatenate([(1 + 2 ** -8 + 2 ** -40)
                        * 2.0 ** rng.integers(-20, 20, 64),
                        rng.standard_normal(4096)])
    got = torch.from_numpy(x).to(BF)
    np.testing.assert_array_equal(bits(got), bits(x.astype(
        ml_dtypes.bfloat16)))
    assert float(got[0]) == 2.0 ** float(np.log2(x[0]) // 1)


def test_dtype_names():
    assert tdev.resolve_dtype("bfloat16") == BF
    assert tcfg.Config(dtype="bfloat16").dtype == "bfloat16"
    with pytest.raises(ValueError, match="float32, float64 or bfloat16"):
        tdev.resolve_dtype("float16")


# ---------------------------------------------------------------------------
# 2. psi_fwdlap and the route on the CPU


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fwdlap_matches_jax(family, monkeypatch):
    """psi_fwdlap in bfloat16 within the bfloat16 tolerances of JAX's, on
    params whose every layer shapes psi; ``routing.psi_lap`` on
    bfloat16 CPU tensors takes the plain version of the family's route and
    keeps the type."""
    fields, route = FAMILIES[family]
    jm = pqs.ModelConfig(hidden=8, **fields)
    tm = tcfg.ModelConfig(hidden=8, **fields)
    params = jax_params(jm)
    pts = bf16_points()
    s64, _ = jans.psi_fwdlap(params, jm, *pts)
    sj, _ = jans.psi_fwdlap(to_bf16(params), jm,
                            *(jnp.asarray(a, JBF) for a in pts))
    tp = tans.from_jax_params(params, dtype="bfloat16", device="cpu")
    tx = [torch.as_tensor(a).to(BF) for a in pts]
    st, _ = tans.psi_fwdlap(tp, tm, *tx)
    for f in ("v", "l"):
        got, want = getattr(st, f)[..., 0], getattr(sj, f)[..., 0]
        assert got.dtype == BF
        assert_bf16_close(got, want, getattr(s64, f)[..., 0],
                          f"{family} {f}")
    calls = []
    mod = {"psi_fwdlap": tans, "psi_lap_separable_plain": tps,
           "psi_lap_train_plain": tpt}[route]
    spy_on(monkeypatch, mod, [route], calls)
    with torch.no_grad():
        psi, lap, _ = trt.psi_lap(tp, tm, *tx)
    assert calls == [route]
    assert psi.dtype == BF and lap.dtype == BF
    assert_bf16_close(psi, sj.v[..., 0], s64.v[..., 0], f"{family} route")
    assert_bf16_close(lap, sj.l[..., 0], s64.l[..., 0], f"{family} route")


@pytest.mark.parametrize("p_sym", [1, -1])
def test_separable_init_fwdlap_is_bitwise(p_sym):
    """At the JAX init of the separable family (the GZ pair, its MLPs'
    output layers zero) both packages round psi and lap psi alike: equal
    bit for bit on 4 096 points. (With trained MLPs XLA fuses their
    arithmetic and rounds less often: test_fwdlap_matches_jax.)"""
    jm = pqs.ModelConfig(arch="separable", inversion_symmetry=p_sym)
    tm = tcfg.ModelConfig(arch="separable", inversion_symmetry=p_sym)
    params = jax.tree.map(np.asarray, jans.init_params(
        jax.random.PRNGKey(0), jm, jnp.float64))
    pts = bf16_points(4096)
    sj, _ = jans.psi_fwdlap(to_bf16(params), jm,
                            *(jnp.asarray(a, JBF) for a in pts))
    st, _ = tans.psi_fwdlap(
        tans.from_jax_params(params, dtype="bfloat16", device="cpu"), tm,
        *(torch.as_tensor(a).to(BF) for a in pts))
    for f in ("v", "l"):
        np.testing.assert_array_equal(bits(getattr(st, f)),
                                      bits(getattr(sj, f)), err_msg=f)


def test_residual_plain_follows_bfloat16():
    """K3's plain version (the reference-parity model with its gate) in
    bfloat16 against JAX's fwdlap pass of the same model."""
    jm, tm = pqs.ModelConfig(hidden=8), tcfg.ModelConfig(hidden=8)
    params = jax_params(jm)
    pts = bf16_points()
    s64, _ = jans.psi_fwdlap(params, jm, *pts)
    sj, _ = jans.psi_fwdlap(to_bf16(params), jm,
                            *(jnp.asarray(a, JBF) for a in pts))
    tp = tans.from_jax_params(params, dtype="bfloat16", device="cpu")
    with torch.no_grad():
        psi, lap = tpr.psi_lap_pallas(tp, tm, *(torch.as_tensor(a).to(BF)
                                                for a in pts))
    assert psi.dtype == BF
    assert_bf16_close(psi, sj.v[..., 0], s64.v[..., 0], "K3 psi")
    assert_bf16_close(lap, sj.l[..., 0], s64.l[..., 0], "K3 lap")


# ---------------------------------------------------------------------------
# 3. losses


def make_train_cfgs(dtype="bfloat16", **train):
    """make train's model (GZ + alpha, paper widths) at a smoke batch."""
    jc = pqs.Config(model=pqs.ModelConfig(gz=True, trainable_exponent=True),
                    train=dataclasses.replace(pqs.TrainConfig(),
                                              n_train=512, **train),
                    dtype=dtype)
    return jc, port_cfg(jc)


def jax_batch_both(jc):
    """A JAX-drawn batch in the config's type, and the same in torch."""
    with jax.enable_x64(False):
        b = jsam.sample_batch(jax.random.PRNGKey(3), jc)
    tb = tsam.Batch(*(torch.as_tensor(np.asarray(a, np.float32)).to(BF)
                      if np.asarray(a).dtype == ml_dtypes.bfloat16 else
                      torch.as_tensor(np.array(a)) for a in b))
    return b, tb


def grads_of(loss_fn, tp):
    leaves = {(k, f): t.detach().clone().requires_grad_(True)
              for k, v in tp.items() for f, t in v.items()}
    tree = {}
    for (k, f), t in leaves.items():
        tree.setdefault(k, {})[f] = t
    loss = loss_fn(tree)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {kf: (torch.zeros_like(t) if g is None else g)
                           for (kf, t), g in zip(leaves.items(), gs)}


def test_loss_fn_value_and_gradient_match_jax():
    """One loss_fn value and gradient at make train's model in bfloat16
    (the K2 route's plain versions here) against JAX's xla route in
    bfloat16, with float64 on the same bfloat16 batch as the truth."""
    jc, tc = make_train_cfgs()
    params = jax_params(jc.model)
    b, tb = jax_batch_both(jc)
    b64 = jsam.Batch(*(np.asarray(a, np.float64)
                       if np.asarray(a).dtype == ml_dtypes.bfloat16
                       else np.asarray(a) for a in b))
    j64 = dataclasses.replace(jc, dtype="float64")

    def jax_value_grad(c, p, batch):
        return jax.value_and_grad(lambda q: jlo.loss_fn(q, c, batch)[0])(p)

    l64, g64 = jax_value_grad(j64, params, b64)
    with jax.enable_x64(False):     # the JAX CLI's bfloat16 run
        lj, gj = jax_value_grad(jc, to_bf16(params), b)
    tp = tans.from_jax_params(params, dtype="bfloat16", device="cpu")
    lt, gt = grads_of(lambda q: tlo.loss_fn(q, tc, tb)[0], tp)
    assert lt.dtype == BF
    assert_bf16_close(lt.reshape(1), np.asarray(lj).reshape(1),
                      np.asarray(l64).reshape(1), "loss")
    assert all(g.dtype == BF for g in gt.values())
    assert_gradient_close(gt, gj, g64)


def assert_gradient_close(port, jax_bf16, truth):
    """The gradient as one vector (every leaf, in the port's key order)
    within the bfloat16 tolerances. Leaf by leaf, both packages' bfloat16
    gradients are sums over the batch whose error against float64 spreads
    from 0.2% to 4% of the leaf's largest entry (neither package's leaves
    are uniformly the closer), so a leaf's own normwise error is no fair
    measure of one package against the other."""
    keys = sorted(port)
    assert_bf16_close(
        np.concatenate([f64(port[kf]).ravel() for kf in keys]),
        np.concatenate([f64(jax_bf16[k][f]).ravel() for k, f in keys]),
        np.concatenate([f64(truth[k][f]).ravel() for k, f in keys]),
        "gradient")


def dual_grid_both(tc):
    """The polish's padded dual-grid batch (port, 8 R rows) in the config's
    type, and the same arrays for JAX, in bfloat16 and in float64."""
    vb = tvar.dual_grid_vbatch(tc, 8, 6, 4, device="cpu")
    vj = jvar.VBatch(*(jnp.asarray(f64(a), JBF) for a in vb))
    v64 = jvar.VBatch(*(jnp.asarray(f64(a)) for a in vb))
    return vb, vj, v64


def assert_quotient_matches(jc, tc, params, vb, vj, v64):
    """quotient_loss in bfloat16, port against JAX with float64 on the same
    bfloat16 batch as the truth: the per-R quotients and the gradient
    within the bfloat16 tolerances, and the loss (a scalar: one draw of
    each package's rounding, so only the gap applies) within BF16_GAP of
    JAX's. Returns the port's (loss, aux, grads)."""
    def jax_value_grad(c, p, v):
        return jax.value_and_grad(lambda q: jvar.quotient_loss(q, c, v),
                                  has_aux=True)(p)

    (l64, a64), g64 = jax_value_grad(
        dataclasses.replace(jc, dtype="float64"), params, v64)
    with jax.enable_x64(False):
        (lj, aj), gj = jax_value_grad(jc, to_bf16(params), vj)
    tp = tans.from_jax_params(params, dtype="bfloat16", device="cpu")
    aux = {}

    def loss(q):
        value, aux["aux"] = tvar.quotient_loss(q, tc, vb)
        return value
    lt, gt = grads_of(loss, tp)
    assert lt.dtype == BF and aux["aux"]["e_r"].dtype == BF
    assert_bf16_close(aux["aux"]["e_r"], aj["e_r"], a64["e_r"], "e_r")
    assert normwise(lt, np.asarray(lj)) <= BF16_GAP
    assert_gradient_close(gt, gj, g64)
    return lt, gt


QUOTIENT_CASES = {
    ("separable", 1): "flagship_separable.npz",
    ("separable", -1): "ungerade_separable.npz",
    ("symmetric", 1): "flagship.npz",
    ("symmetric", -1): "ungerade_2psu.npz",
}


@pytest.mark.parametrize("arch,p_sym", list(QUOTIENT_CASES))
def test_quotient_loss_on_padded_dual_grid(arch, p_sym):
    """quotient_loss in bfloat16 on the polish's padded dual grid (K1's or
    K2's plain versions, as the bfloat16 builds compute: float32 arithmetic
    rounded once) for a shipped artifact of each family and sector,
    against JAX in bfloat16; the pad points (weight 0) bitwise inert; no
    gradient on the ungerade output bias."""
    fields = (dict(arch="separable") if arch == "separable"
              else dict(gz=True, trainable_exponent=True))
    jm = pqs.ModelConfig(inversion_symmetry=p_sym, **fields)
    params = load_artifact(QUOTIENT_CASES[(arch, p_sym)])
    jc = pqs.Config(model=jm, dtype="bfloat16")
    tc = port_cfg(jc)
    vb, vj, v64 = dual_grid_both(tc)
    assert vb.x.dtype == BF
    pad = vb.w == 0
    assert int(pad.sum()) > 0 and bool((vb.x[pad] == 1.0).all())
    lt, gt = assert_quotient_matches(jc, tc, params, vb, vj, v64)
    tp = tans.from_jax_params(params, dtype="bfloat16", device="cpu")
    moved = tvar.VBatch(torch.where(pad, 2.5, vb.x).to(BF),
                        torch.where(pad, 0.7, vb.y).to(BF),
                        torch.where(pad, 0.3, vb.z).to(BF), vb.w, vb.r)
    lm, gm = grads_of(lambda q: tvar.quotient_loss(q, tc, moved)[0], tp)
    assert torch.equal(lm, lt)
    assert all(torch.equal(gm[kf], g) for kf, g in gt.items())
    if arch == "symmetric" and p_sym < 0:
        assert not bool(gt[("out", "b")].any())


@pytest.mark.parametrize("arch", ["separable", "symmetric"])
def test_mc_quotient_on_jax_samples(arch):
    """The Monte-Carlo quotient_loss in bfloat16 on JAX's importance
    samples (drawn in bfloat16, 8 R rows), against JAX's, with float64 on
    the same samples as the truth."""
    fields = (dict(arch="separable") if arch == "separable"
              else dict(gz=True, trainable_exponent=True))
    jm = pqs.ModelConfig(**fields)
    params = load_artifact(QUOTIENT_CASES[(arch, 1)])
    jc = pqs.Config(model=jm, dtype="bfloat16")
    tc = port_cfg(jc)
    with jax.enable_x64(False):
        # not antithetic: JAX's antithetic shells draw their bfloat16
        # uniforms down to 0, and some weights are inf (the port draws the
        # uniforms in float64, ops/sampling.py)
        vj = jvar.sample_vbatch(jax.random.PRNGKey(7), jc, 8, 256,
                                stratified=True)
    v64 = jvar.VBatch(*(jnp.asarray(f64(a)) for a in vj))
    vb = tvar.VBatch(*(torch.as_tensor(f64(a)).to(BF) for a in vj))
    assert_quotient_matches(jc, tc, params, vb, vj, v64)


# ---------------------------------------------------------------------------
# 4. the trainer's Adam step


def test_trainer_adam_step_matches_optax():
    """One step of engine.Trainer in bfloat16 (its flat Adam vector and
    moments in bfloat16, as optax's mu and nu take the params' type)
    against the JAX engine's step, from the same params on the same batch:
    each leaf within one bfloat16 unit of JAX's (normwise), the loss
    within BF16_GAP, and the best loss in float32."""
    jc, tc = make_train_cfgs(epochs=1)
    params = jax_params(jc.model)
    b, tb = jax_batch_both(jc)
    with jax.enable_x64(False):
        opt = jeng.make_optimizer(jc)
        p0 = jax.tree.map(jnp.asarray, to_bf16(params))
        state = jeng.TrainState(
            step=jnp.asarray(1, jnp.int32), params=p0,
            opt_state=opt.init(p0), batch=b, best_params=p0,
            best_loss=jnp.asarray(jnp.inf, jnp.float32), ema_params=p0,
            key=jax.random.PRNGKey(0))
        new, hist = jeng.make_step(jc, opt)(state, None)
    tr = teng.Trainer(tc, tans.from_jax_params(params, dtype="bfloat16",
                                               device="cpu"),
                      batch=tb, start_step=1, device="cpu")
    assert tr.flat.dtype == BF and tr.best_loss.dtype == torch.float32
    h = tr.advance(lambda g: tb)
    st = tr.state()
    assert tr.opt.mu.dtype == tr.opt.nu.dtype == BF
    assert st.best_loss.dtype == torch.float32
    assert normwise(h.l_tot, np.asarray(hist.l_tot)) <= BF16_GAP
    for k in new.params:
        for f in new.params[k]:
            # one bfloat16 unit (2^-7, the spacing) of the leaf's largest
            # entry: where a gradient entry is near 0 the two packages'
            # bfloat16 gradients differ in it, and Adam's normalised step
            # (about lr whatever the gradient's size) with it
            assert normwise(st.params[k][f], new.params[k][f]) \
                <= 2.0 ** -7, (k, f)


# ---------------------------------------------------------------------------
# 7. the CUDA wrappers' refusals, and the dtype tables


def test_wrappers_refuse_bfloat16_on_the_cpu_and_mixed_types():
    """A bfloat16 CPU tensor reaching a ``*_cuda`` wrapper raises (the
    wrapper launches its kernel or raises, never the plain version), and
    inputs of two types raise before any device check."""
    jm = pqs.ModelConfig(hidden=8, arch="separable")
    tp = tans.from_jax_params(jax_params(jm), dtype="bfloat16", device="cpu")
    x = torch.ones(64, dtype=BF)
    ws = tps.kernel_weights(tp, BF)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tps.separable_fwd_cuda(ws, x, x, x, x, x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tps.separable_bwd_cuda(ws, x, x, x, x, x, x, x, x,
                               point_grads=True)
    with pytest.raises(TypeError, match="share one dtype"):
        tps.separable_fwd_cuda(ws, x, x, x.float(), x, x, x)
    sm = pqs.ModelConfig(hidden=8, gz=True, trainable_exponent=True)
    sp = tans.from_jax_params(jax_params(sm), dtype="bfloat16", device="cpu")
    ws2 = tpt.kernel_weights(sp, port_cfg(pqs.Config(model=sm)).model, BF)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpt.train_fwd_cuda(ws2, x, x, x, x, x, x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpt.train_bwd_cuda(ws2, x, x, x, x, x, x, x, x, x)
    with pytest.raises(TypeError, match="share one dtype"):
        tpt.train_fwd_cuda([w.double() for w in ws2], x, x, x, x, x, x, x)
    rp = pqs.ModelConfig(hidden=8)
    rw = tpr.kernel_weights(tans.from_jax_params(
        jax_params(rp), dtype="bfloat16", device="cpu"),
        port_cfg(pqs.Config(model=rp)).model, BF)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpr.residual_fwd_cuda(rw, x, x, x, x)
    with pytest.raises(TypeError, match="float32/float64/bfloat16"):
        tpr.residual_fwd_cuda(rw, *(x.half(),) * 4)
    for mod in (tps, tpt, tpr):
        assert all(v == 0 for v in mod.launches.values())


def test_type_tables():
    """Each storage type's entry point and type code (csrc/common.cuh);
    the bfloat16 builds' tables are the float32 build's; a bfloat16
    backward sums float32 partials and rounds once."""
    assert [_cuda.suffix(t) for t in (torch.float32, torch.float64, BF)] \
        == ["f32", "f64", "bf16"]
    assert [_cuda.TYPE_CODE[t] for t in (torch.float32, torch.float64, BF)] \
        == [0, 1, 2]
    assert _cuda.partials_dtype(BF) == torch.float32
    assert _cuda.partials_dtype(torch.float64) == torch.float64
    assert _cuda.launch_key("train_fwd", BF) == "train_fwd_bf16"
    assert _cuda.launch_key("train_fwd", torch.float32) == "train_fwd"
    for h in _cuda.SUPPORTED_HIDDEN:
        assert tpt.points_per_tile(h, BF) == tpt.points_per_tile(
            h, torch.float32)
    assert _cuda.GRID_BLOCKS_PER_SM[BF] == \
        _cuda.GRID_BLOCKS_PER_SM[torch.float32]
    assert _cuda.threads(BF) == _cuda.threads(torch.float32)
    for n in (1, 1100, 164_502):
        assert _cuda.grid_blocks(n, tpt.points_per_tile(16, BF), BF) == \
            _cuda.grid_blocks(n, tpt.points_per_tile(16, torch.float32),
                              torch.float32)
    # float32 rows of bfloat16 terms: summed in float32, rounded once
    rows = torch.full((300, 1), 1.0 + 2.0 ** -9)
    got = _cuda.sum_partials(rows, BF)
    assert got.dtype == BF and float(got[0]) == float(
        torch.tensor(300 * (1.0 + 2.0 ** -9)).to(BF))


# ---------------------------------------------------------------------------
# 8. chip_smoke.py's phase 23 constants


def test_chip_smoke_bfloat16_constants():
    """Phase 23's tolerances in bfloat16 units (u = 2^-8: one rounding of a
    float32 result; two for the cotangents, float32 sums of rounded terms),
    the bound (the float32 build's operations, the H x H products at the
    card's bfloat16 tensor-core peak and the rest at FP32's, on half the
    float32 bytes), the quotients of cli evaluate --table-knots 0 at the
    default R domain, and ptxas's bfloat16 entries parsed."""
    import chip_smoke
    u = 2.0 ** -8
    assert u < chip_smoke.BF16_OUT_TOL < 1.05 * u
    assert 2 * u < chip_smoke.BF16_COT_TOL < 2.1 * u
    assert chip_smoke.BF16_OUT_TOL < chip_smoke.BF16_F64_TOL \
        < chip_smoke.BF16_PLAIN_TOL
    dom = tcfg.DomainConfig()
    targets = np.round(np.arange(dom.r_lo, dom.r_hi + 0.05, 0.05), 3)
    surface = np.round(np.arange(dom.r_lo, dom.r_hi + 0.1, 0.1), 2)
    assert chip_smoke.BF16_EVAL_QUOTIENTS == len(targets) + len(surface)
    for kern, which in (("K1", "fwd"), ("K1", "bwd_pg"), ("K2", "bwd"),
                        ("K3", "fwd")):
        for n in (1100, 164_502, 1 << 20):
            b16, by16 = chip_smoke.bound_ms(n, 16, "bfloat16", which, kern)
            b32, by32 = chip_smoke.bound_ms(n, 16, "float32", which, kern)
            ops = b32 * 1e-3 * 67e12
            products = n * chip_smoke.PRODUCT_H2[(kern, which)] * 16 * 16
            assert by16 == by32 == "operations"
            assert b16 == pytest.approx(1e3 * max(
                products / 989e12, (ops - products) / 67e12), rel=1e-12)
            assert b16 < b32 / 2
    log = ("ptxas info    : Compiling entry function '_ZN3trn22train_fwd_"
           "point_kernelI13__nv_bfloat16Li16ENS_10ReadSourceEfEEvPKT_' for "
           "'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 160 registers, used 1 barriers\n")
    (entry,) = chip_smoke.ptxas_entries("train_fwd", log)
    assert (entry["dtype"], entry["h"], entry["pg"], entry["registers"]) \
        == ("bfloat16", 16, False, 160)
