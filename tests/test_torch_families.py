"""The paths across families of the PyTorch port against the JAX package.

Every family on every objective: the minimal family and R-input models
(the plain forward-Laplacian path on every device), separable params on the
residual trainer (K1's plain versions here), symmetric params on the
spheroidal polish's padded dual grid (K2's plain versions here), the
``model.bin`` codec and the CLI subcommands that reach them. The same
parameters (drawn by the JAX package) and the same numpy-seeded points go
through both packages in float64: psi and lap psi to rtol 1e-12, loss values
to 1e-12 and gradients to 1e-8 (relative), against JAX's ``loss_fn`` at
``kernel="pallas"`` (interpret mode) where its kernels carry the model and
at ``"xla"``. torch runs on one thread (see test_torch_excited.py)."""

import argparse
import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.analysis import energy as jen
from pinn_for_quantum_wavefunction_surfaces_tpu.io import checkpoint as jckpt
from pinn_for_quantum_wavefunction_surfaces_tpu.io import modelbin as jbin
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
from pinn_for_quantum_wavefunction_surfaces_tpu.ops import sampling as jsam
from pinn_for_quantum_wavefunction_surfaces_tpu.training import losses as jlo
from pinn_for_quantum_wavefunction_surfaces_tpu.training import \
    variational as jvar
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import cli
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    energy as ten
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
    modelbin as tbin
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_residual as tpr
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_separable as tps
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_train as tpt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    routing as trt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    losses as tlo
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    variational as tvar

from test_torch_excited import one_torch_thread, spy_on  # noqa: F401
from test_torch_sampling_losses import port_cfg, to_port_batch
from test_torch_separable import (ARTIFACTS, as_t, no_jax_cache_writes,  # noqa: F401,E501
                                  points)

MODEL_BIN = os.path.join(ARTIFACTS, "flagship_model.bin")

# the models the kernels do not carry: (ModelConfig fields)
FWDLAP_FAMILIES = {
    "minimal": dict(arch="minimal"),
    "minimal_r_input": dict(arch="minimal", r_input=True),
    "symmetric_r_input": dict(r_input=True),
    "symmetric_r_input_gz_ungerade": dict(r_input=True, gz=True,
                                          trainable_exponent=True,
                                          inversion_symmetry=-1),
}


def jax_params(mcfg, seed=0):
    """JAX-drawn params of any family in numpy, the heads' zero output
    weights knocked off zero so that every head shapes psi."""
    p = jans.init_params(jax.random.PRNGKey(seed), mcfg, jnp.float64)
    p = jax.tree.map(np.asarray, p)
    for k, dw in (("alpha2", 0.3), ("beta2", 0.2), ("xalpha2", 0.3),
                  ("lamout", 0.15), ("muout", 0.15)):
        if k in p:
            p[k] = {"w": p[k]["w"] + dw, "b": p[k]["b"] + 0.05}
    return p


def both(**fields):
    return pqs.ModelConfig(hidden=4, **fields), \
        tcfg.ModelConfig(hidden=4, **fields)


def test_minimal_config_matches_jax():
    for over in ({}, dict(dtype="float64")):
        assert port_cfg(pqs.minimal_config(**over)) == \
            tcfg.minimal_config(**over)


@pytest.mark.parametrize("family", list(FWDLAP_FAMILIES))
def test_psi_and_fwdlap_match_jax(family):
    jm, tm = both(**FWDLAP_FAMILIES[family])
    params = jax_params(jm)
    pts = points(300)
    tp = tans.from_jax_params(params, device="cpu")
    psi_j, e_j = jans.psi(params, jm, *pts)
    psi_t, e_t = tans.psi(tp, tm, *as_t(*pts))
    np.testing.assert_allclose(psi_t.numpy(), np.asarray(psi_j), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-14)
    s_j, _ = jans.psi_fwdlap(params, jm, *pts)
    s_t, _ = tans.psi_fwdlap(tp, tm, *as_t(*pts))
    for f in ("v", "g", "l"):
        np.testing.assert_allclose(getattr(s_t, f).numpy(),
                                   np.asarray(getattr(s_j, f)), rtol=1e-12,
                                   atol=1e-14, err_msg=f)
    # the fused pass and the value-only forward are one function
    np.testing.assert_allclose(s_t.v[..., 0].numpy(), psi_t.numpy(),
                               rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("family", ["minimal", "minimal_r_input",
                                    "symmetric_r_input_gz_ungerade"])
def test_init_matches_jax_layout(family):
    """The port's seeded init has JAX's tree and shapes; the minimal family
    draws its biases from U(+-1/sqrt(fan_out)) and keeps the E head's
    drawn output bias."""
    jm, tm = both(**FWDLAP_FAMILIES[family])
    want = jax_params(jm)
    got = tans.to_numpy_params(tans.init_params(tm, seed=3, dtype="float64",
                                                device="cpu"))
    assert {k: {f: a.shape for f, a in v.items()} for k, v in got.items()} \
        == {k: {f: a.shape for f, a in v.items()} for k, v in want.items()}
    assert got["h1"]["w"].shape[0] == (3 if tm.r_input else 2)
    if tm.arch == "minimal":
        for k in ("h1", "h2", "out", "e1", "e2", "eout", "gate1", "gate2"):
            bound = 1.0 / np.sqrt(got[k]["b"].shape[0])
            assert np.abs(got[k]["b"]).max() <= bound
        assert got["eout"]["b"][0] != tm.eout_bias_init
    else:
        assert got["eout"]["b"][0] == tm.eout_bias_init


# (family, JAX kernel): JAX's Pallas kernels carry separable and 2-input
# symmetric params; its pallas_train raises on the minimal and R-input ones
LOSS_CASES = [("separable", "pallas"), ("separable", "xla"),
              ("symmetric", "pallas"), ("symmetric", "xla"),
              ("minimal", "xla"), ("symmetric_r_input", "xla")]
LOSS_PATH = {"separable": "psi_lap_train_separable",
             "symmetric": "psi_lap_train", "minimal": "psi_fwdlap",
             "symmetric_r_input": "psi_fwdlap"}
_VG = jax.jit(jax.value_and_grad(jlo.loss_fn, has_aux=True),
              static_argnums=1)


@pytest.mark.parametrize("family,kernel", LOSS_CASES)
def test_loss_fn_matches_jax(family, kernel, monkeypatch):
    fields = {"separable": dict(arch="separable"),
              "symmetric": dict(gz=True, trainable_exponent=True),
              "minimal": dict(arch="minimal"),
              "symmetric_r_input": dict(r_input=True)}[family]
    jm, _ = both(**fields)
    params = jax_params(jm)
    base = pqs.minimal_config if family == "minimal" else pqs.smoke_config
    jcfg = base(dtype="float64", model=jm)
    jcfg = dataclasses.replace(
        jcfg, train=dataclasses.replace(jcfg.train, kernel=kernel),
        domain=dataclasses.replace(jcfg.domain, box=6.0, bc_cutoff=5.0))
    batch = jsam.sample_batch(jax.random.PRNGKey(3), jcfg, n=384)
    (l_j, aux_j), g_j = _VG(params, jcfg, batch)
    calls = []
    spy_on(monkeypatch, trt, ["psi_lap_train_separable", "psi_lap_train"],
           calls)
    spy_on(monkeypatch, tans, ["psi_fwdlap"], calls)
    l_t, aux_t, g_t = tlo.loss_and_grad(
        tans.from_jax_params(params, device="cpu"), port_cfg(jcfg),
        to_port_batch(batch))
    assert calls == [LOSS_PATH[family]]
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-12)
    for a, b in zip(aux_t, aux_j):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-12)
    for k in params:
        for f in params[k]:
            want = np.asarray(g_j[k][f])
            np.testing.assert_allclose(
                g_t[k][f].numpy(), want, rtol=1e-8,
                atol=1e-8 * max(np.abs(want).max(), 1e-300),
                err_msg=f"{k}/{f}")


def _quotient_and_grads(tp, tc, vb):
    leaves = {(k, f): t.detach().clone().requires_grad_(True)
              for k, v in tp.items() for f, t in v.items()}
    tree = {}
    for (k, f), t in leaves.items():
        tree.setdefault(k, {})[f] = t
    loss, aux = tvar.quotient_loss(tree, tc, vb)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), aux, {kf: (torch.zeros_like(t) if g is None else g)
                                for (kf, t), g in zip(leaves.items(), grads)}


@pytest.mark.parametrize("p_sym", [1, -1])
def test_symmetric_quotient_on_padded_dual_grid(p_sym, monkeypatch):
    """quotient_loss of symmetric (GZ + alpha) params on the polish's padded
    dual-grid batch: K2's path in the port (its heads once an R row,
    ``routing.psi_lap_rows``), JAX's forward-Laplacian pass, equal in value
    and gradients. The pad points (weight 0) contribute
    exactly nothing: moving them leaves value and gradients bit for bit,
    and in the ungerade sector the output bias gets no gradient."""
    jm, tm = both(gz=True, trainable_exponent=True, inversion_symmetry=p_sym)
    params = jax_params(jm)
    jc = pqs.Config(model=jm, dtype="float64")
    tc = tcfg.Config(model=tm, dtype="float64")
    vb = tvar.dual_grid_vbatch(tc, 2, 6, 4, device="cpu")
    pad = vb.w == 0
    assert int(pad.sum()) > 0 and bool((vb.x[pad] == 1.0).all())
    vj = jvar.VBatch(*(jnp.asarray(a.numpy()) for a in vb))
    (l_j, aux_j), g_j = jax.jit(jax.value_and_grad(jvar.quotient_loss,
                                                   has_aux=True),
                                static_argnums=1)(params, jc, vj)
    calls = []
    spy_on(monkeypatch, trt, ["psi_lap_train", "psi_lap_train_separable",
                              "train_psi_lap", "separable_psi_lap"], calls)
    spy_on(monkeypatch, tans, ["psi_fwdlap"], calls)
    tp = tans.from_jax_params(params, device="cpu")
    l_t, aux_t, g_t = _quotient_and_grads(tp, tc, vb)
    assert calls == ["train_psi_lap"]
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-12)
    np.testing.assert_allclose(aux_t["e_r"].detach().numpy(),
                               np.asarray(aux_j["e_r"]), rtol=1e-12)
    for (k, f), g in g_t.items():
        want = np.asarray(g_j[k][f])
        np.testing.assert_allclose(
            g.numpy(), want, rtol=1e-8,
            atol=1e-8 * max(np.abs(want).max(), 1e-300), err_msg=f"{k}/{f}")
    moved = tvar.VBatch(torch.where(pad, 2.5, vb.x), torch.where(pad, 0.7,
                                                                 vb.y),
                        torch.where(pad, 0.3, vb.z), vb.w, vb.r)
    l_m, _, g_m = _quotient_and_grads(tp, tc, moved)
    assert torch.equal(l_m, l_t)
    assert all(torch.equal(g_m[kf], g) for kf, g in g_t.items())
    if p_sym < 0:
        assert not bool(g_t[("out", "b")].any())


def test_k2_and_the_guard_refuse_minimal_and_r_input():
    """``routing.kernel_of`` gives no kernel the minimal family (keyed by
    the config: its params are the reference-parity tree) nor 3-input h1;
    the wrappers refuse both before they touch a tensor, so on every
    device (here also on meta tensors, which hold no data)."""
    for fields in (dict(arch="minimal"), dict(r_input=True),
                   dict(arch="minimal", r_input=True)):
        jm, tm = both(**fields)
        tp = tans.from_jax_params(jax_params(jm), device="cpu")
        assert trt.kernel_of(tp, tm) is trt.kernel_of(tp, tm, True) is None
        for dev in ("cpu", "meta"):
            x = torch.ones(8, dtype=torch.float64, device=dev)
            with pytest.raises(NotImplementedError, match="psi_fwdlap"):
                tpt.psi_lap_train(tp, tm, x, x, x, x)
            with pytest.raises(NotImplementedError):
                tpr.psi_lap_pallas(tp, tm, x, x, x, x)
            with pytest.raises(NotImplementedError):
                tps.psi_lap_train_separable(tp, tm, x, x, x, x)
    # the same tree under the symmetric config is the reference-parity
    # model, which K2 and K3 carry
    jm, tm = both()
    tp = tans.from_jax_params(jax_params(jm), device="cpu")
    assert trt.kernel_of(tp, tm) == "K2"
    assert trt.kernel_of(tp, tm, forward_only=True) == "K3"


# (ModelConfig fields, kernel_of's kernel on a training call, on a
# forward-only call): every family of the port
KERNEL_CASES = {
    "separable": (dict(arch="separable"), "K1", "K1"),
    "separable_radial_node": (dict(arch="separable", xi_node=True), "K1",
                              "K1"),
    "separable_two_radial_nodes": (dict(arch="separable", xi_node=True,
                                        xi_node2=True), "K1", "K1"),
    "separable_angular_node": (dict(arch="separable", eta_node=True), "K1",
                               "K1"),
    "separable_m_abs": (dict(arch="separable", m_abs=1, wide_alpha=True),
                        "K1", "K1"),
    "reference_parity": (dict(), "K2", "K3"),
    "symmetric_gz_alpha": (dict(gz=True, trainable_exponent=True), "K2",
                           "K2"),
    "symmetric_alpha": (dict(trainable_exponent=True), "K2", "K2"),
    "minimal": (dict(arch="minimal"), None, None),
    "minimal_r_input": (dict(arch="minimal", r_input=True), None, None),
    "symmetric_r_input": (dict(r_input=True), None, None),
}
ENTRIES = {"K1": lambda tp, tm, x: tps.psi_lap_train_separable(
               tp, tm, x, x, x, x),
           "K2": lambda tp, tm, x: tpt.psi_lap_train(tp, tm, x, x, x, x),
           "K3": lambda tp, tm, x: tpr.psi_lap_pallas(tp, tm, x, x, x, x)}


@pytest.mark.parametrize("family", list(KERNEL_CASES))
def test_kernel_of_every_family(family, monkeypatch):
    """``routing.kernel_of`` is the one rule: each family's kernel on a
    training and on a forward-only call; each wrapper's JAX-named entry
    runs exactly the params the rule gives it and refuses the rest; and
    the routes take the kernel the rule names (``psi_lap_forward`` K3's
    entry only on the reference-parity model)."""
    fields, train, forward = KERNEL_CASES[family]
    tm = tcfg.ModelConfig(hidden=4, **fields)
    tp = tans.init_params(tm, seed=0, dtype="float64", device="cpu")
    assert trt.kernel_of(tp, tm) == train
    assert trt.kernel_of(tp, tm, forward_only=True) == forward
    x = torch.full((4,), 0.7, dtype=torch.float64)
    for kernel, entry in ENTRIES.items():
        if kernel in (train, forward):
            with torch.no_grad():
                psi, lap = entry(tp, tm, x)[:2]
            assert psi.shape == lap.shape == x.shape
        else:
            with pytest.raises(NotImplementedError,
                               match=f"{kernel} does not carry"):
                entry(tp, tm, x)
    calls = []
    spy_on(monkeypatch, trt, ["psi_lap_train_separable", "psi_lap_train",
                              "psi_lap_pallas"], calls)
    spy_on(monkeypatch, tans, ["psi_fwdlap"], calls)
    trt.psi_lap_forward(tp, tm, x, x, x, x)
    want = {"K1": "psi_lap_train_separable", "K2": "psi_lap_train",
            "K3": "psi_lap_pallas", None: "psi_fwdlap"}
    assert calls == [want[forward]]


def test_modelbin_round_trip():
    """The port's reader equals the JAX package's on the shipped
    model.bin, and its writer reproduces the file byte for byte."""
    got, want = tbin.load_params(MODEL_BIN), jbin.load_params(MODEL_BIN)
    assert sorted(got) == sorted(want) == ["e1", "e2", "eout", "gate1",
                                           "gate2", "h1", "h2", "out"]
    for k in want:
        for f in ("w", "b"):
            assert got[k][f].dtype == np.float64
            np.testing.assert_array_equal(got[k][f], want[k][f])
    assert got["h1"]["w"].shape == (2, 16)
    assert got["gate1"]["w"].shape == (1, 10)
    assert got["e1"]["w"].shape == (1, 32)
    assert len(tbin.read_arrays(MODEL_BIN)) == 16


def test_modelbin_writes_what_jax_reads(tmp_path):
    path = str(tmp_path / "m.bin")
    tbin.save_params(path, tans.from_jax_params(tbin.load_params(MODEL_BIN),
                                                device="cpu"))
    with open(path, "rb") as a, open(MODEL_BIN, "rb") as b:
        assert a.read() == b.read()
    _, tm = both(arch="minimal", r_input=True)
    params = tans.to_numpy_params(tans.init_params(tm, seed=1,
                                                   dtype="float64",
                                                   device="cpu"))
    tbin.save_params(path, params)
    again = jbin.load_params(path)
    for k in again:
        for f in ("w", "b"):
            np.testing.assert_array_equal(again[k][f], params[k][f])
    with pytest.raises(ValueError, match="16 records"):
        tbin.write_arrays(path, [np.zeros(3)])
        tbin.load_params(path)


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [["--arch", "separable"],
                                   ["--arch", "minimal"],
                                   ["--arch", "minimal", "--r-input"],
                                   ["--r-input", "--gz"]])
def test_cli_train_every_family(flags, tmp_path, capsys):
    """cli train of every family on the CPU at a tiny size, then its
    fine-tune; the checkpoints hold the family's tree, and the minimal
    family runs minimal_config's domain and convention."""
    out = str(tmp_path / "s1")
    cli.main(["train", "--device", "cpu", "--epochs", "4", "--n-train",
              "256", "--dtype", "float64", "--hidden", "4", "--out", out]
             + flags)
    summary = last_json(capsys)
    assert np.isfinite(summary["best_loss"])
    tree, _ = jckpt.load_params(os.path.join(out, "final.npz"))
    params = tree["params"]
    if "separable" in flags:
        assert "lam1" in params and params["lam1"]["w"].shape == (2, 4)
    else:
        assert params["h1"]["w"].shape == (3 if "--r-input" in flags else 2,
                                           4)
    with open(os.path.join(out, "history.pkl"), "rb") as f:
        hist = pickle.load(f)
    assert np.isfinite(np.asarray(hist["Ltot"])).all()
    ft = str(tmp_path / "s2")
    cli.main(["finetune", os.path.join(out, "best.npz"), "--device", "cpu",
              "--epochs", "2", "--n-train", "128", "--dtype", "float64",
              "--out", ft] + flags)
    tuned, _ = jckpt.load_params(os.path.join(ft, "finetune.npz"))
    best, _ = jckpt.load_params(os.path.join(out, "best.npz"))
    frozen = "lam2" if "separable" in flags else "h2"
    np.testing.assert_array_equal(tuned["params"][frozen]["w"],
                                  best["params"][frozen]["w"])


def test_a_minimal_checkpoint_names_its_family(tmp_path, capsys,
                                               monkeypatch):
    """A port-trained minimal .npz carries arch in its meta (its params
    have the reference-parity tree), so finetune and energy without
    --arch take the minimal family: psi_fwdlap, never K3, and the same
    surface as under --arch minimal."""
    out = str(tmp_path / "s1")
    cli.main(["train", "--arch", "minimal", "--device", "cpu", "--epochs",
              "2", "--n-train", "128", "--dtype", "float64", "--hidden", "4",
              "--ema-decay", "0.9", "--out", out])
    for name in ("final.npz", "best.npz", "state.npz", "ema.npz"):
        assert jckpt.load_meta(os.path.join(out, name))["arch"] == "minimal"
    best = os.path.join(out, "best.npz")
    ft = str(tmp_path / "s2")
    cli.main(["finetune", best, "--device", "cpu", "--epochs", "1",
              "--n-train", "128", "--dtype", "float64", "--out", ft])
    assert jckpt.load_meta(os.path.join(ft, "finetune.npz")) == {
        "best_loss": last_json(capsys)["best_loss"], "arch": "minimal"}
    calls = []
    spy_on(monkeypatch, trt, ["psi_lap_pallas"], calls)
    spy_on(monkeypatch, tans, ["psi_fwdlap"], calls)
    surfs = []
    for flags in ([], ["--arch", "minimal"]):
        pkl = str(tmp_path / f"e{len(surfs)}.pkl")
        calls.clear()
        cli.main(["energy", best, "--device", "cpu", "--dtype", "float64",
                  "--n-test", "10", "--r-lo", "0.8", "--r-hi", "1.0",
                  "--no-lcao", "--out", pkl] + flags)
        surfs.append(ten.load_surface(pkl))
        assert calls == ["psi_fwdlap"] * len(surfs[-1]["R"])
    for k in ("R", "E_int", "E_net"):
        np.testing.assert_array_equal(surfs[0][k], surfs[1][k])
    # the flag still overrides the meta
    calls.clear()
    cli.main(["energy", best, "--arch", "symmetric", "--device", "cpu",
              "--dtype", "float64", "--n-test", "10", "--r-lo", "0.8",
              "--r-hi", "1.0", "--no-lcao", "--out",
              str(tmp_path / "sym.pkl")])
    assert calls == ["psi_lap_pallas"] * len(surfs[0]["R"])


def test_cli_minimal_takes_minimal_config():
    args = argparse.Namespace(
        arch="minimal", state="gerade", dtype="float32", dom_r_lo=None,
        dom_r_hi=None)
    cfg = cli._build_cfg(args)
    assert cfg == tcfg.minimal_config()
    args.arch = "symmetric"
    assert cli._build_cfg(args) == tcfg.Config()


def test_cli_variational_symmetric_spheroidal(tmp_path, capsys):
    """The polish of the symmetric family (GZ + alpha) on the CPU: K2's
    plain path, both checkpoints, the JAX CLI's keys."""
    out = str(tmp_path / "v")
    cli.main(["variational", "--arch", "symmetric", "--gz",
              "--trainable-exponent", "--spheroidal", "--adam-warmup", "3",
              "--lbfgs", "2", "--n-r", "2", "--n-xi", "8", "--n-eta", "6",
              "--hidden", "4", "--dtype", "float64", "--device", "cpu",
              "--out", out])
    got = last_json(capsys)
    assert got["polish"] == "spheroidal-lbfgs" and got["spheroidal"]
    tree, meta = jckpt.load_params(os.path.join(out, "variational.npz"))
    assert meta == {"polish": "spheroidal-lbfgs"}
    assert {"alpha1", "beta1", "h1", "gate1"} <= set(tree["params"])
    jm = pqs.ModelConfig(hidden=4, gz=True, trainable_exponent=True)
    p = jax.tree.map(jnp.asarray, tree["params"])
    psi, _ = jans.psi(p, jm, *points(16))
    assert np.isfinite(np.asarray(psi)).all()


@pytest.mark.parametrize("arch", ["symmetric", "minimal"])
def test_cli_energy_of_a_bin(arch, tmp_path, capsys, monkeypatch):
    """cli energy of the shipped model.bin on the CPU at a tiny grid: the
    reference-parity model by default (K3's plain path), the minimal
    family under --arch minimal (the forward-Laplacian pass, and never
    K3: the two share the params tree); the surface equals the JAX
    package's at the same grid."""
    calls = []
    spy_on(monkeypatch, trt, ["psi_lap_pallas"], calls)
    spy_on(monkeypatch, tans, ["psi_fwdlap"], calls)
    out = str(tmp_path / "e.pkl")
    flags = [] if arch == "symmetric" else ["--arch", "minimal"]
    cli.main(["energy", MODEL_BIN, "--device", "cpu", "--dtype", "float64",
              "--n-test", "10", "--r-lo", "0.8", "--r-hi", "1.0", "--out",
              out] + flags)
    summary = last_json(capsys)
    assert np.isfinite(summary["max_err_mHa"])
    surf = ten.load_surface(out)
    want_path = "psi_lap_pallas" if arch == "symmetric" else "psi_fwdlap"
    assert calls == [want_path] * len(surf["R"])
    jcfg = (pqs.minimal_config if arch == "minimal" else pqs.Config)(
        dtype="float64")
    jcfg = dataclasses.replace(jcfg, domain=dataclasses.replace(
        jcfg.domain, r_lo=0.8, r_hi=1.0))
    want = jen.surface(jbin.load_params(MODEL_BIN), jcfg, n=10)
    for k in ("R", "E_int", "E_net", "Elcao"):
        np.testing.assert_allclose(surf[k], np.asarray(want[k]), rtol=1e-10,
                                   err_msg=k)


def test_the_bin_is_two_models():
    """The one tree under the two configs is two wavefunctions: the
    symmetric family adds the mirrored branch where the minimal one doubles
    its single branch, so psi differs where f1 != f2 (the quotient barely
    does: the difference is inversion-odd)."""
    tp = tans.from_jax_params(tbin.load_params(MODEL_BIN), device="cpu")
    x, y, z, r = as_t(*points(64))
    sym, _ = tans.psi(tp, tcfg.ModelConfig(), x, y, z, r)
    mini, _ = tans.psi(tp, tcfg.ModelConfig(arch="minimal"), x, y, z, r)
    assert float((sym - mini).abs().max()) > 1e-6 * float(sym.abs().max())


def test_chip_smoke_family_goldens():
    """chip_smoke.py phase 19d's frozen JAX values: recomputed with the JAX
    package (the spheroidal quotients at every R, the 80^3 ones at one R
    each), and the port's own on the CPU against them."""
    import chip_smoke
    binp = jbin.load_params(MODEL_BIN)
    for arch, want in chip_smoke.JAX_EINT_BIN.items():
        jcfg = (pqs.minimal_config if arch == "minimal" else pqs.Config)(
            dtype="float64")
        ri = min(want)
        got = float(jen.rayleigh_quotient(binp, jcfg, ri, n=80))
        np.testing.assert_allclose(got, want[ri], rtol=1e-12)
    for name, (weights, fields) in chip_smoke.family_models().items():
        jcfg = pqs.Config(model=pqs.ModelConfig(**fields), dtype="float64")
        tc = tcfg.Config(model=tcfg.ModelConfig(**fields), dtype="float64")
        tp = tans.from_jax_params(weights, device="cpu")
        for ri, (uniform, spheroidal) in chip_smoke.JAX_EINT_FAMILY[
                name].items():
            np.testing.assert_allclose(
                float(jen.rayleigh_quotient_spheroidal(weights, jcfg, ri)),
                spheroidal, rtol=1e-12)
            np.testing.assert_allclose(
                ten.rayleigh_quotient_spheroidal(tp, tc, ri), spheroidal,
                rtol=1e-10)
        np.testing.assert_allclose(
            float(jen.rayleigh_quotient(weights, jcfg, 1.0, n=80)),
            chip_smoke.JAX_EINT_FAMILY[name][1.0][0], rtol=1e-12)
