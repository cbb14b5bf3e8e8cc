"""The residual trainer of the PyTorch port (training/engine.py, the
``train`` / ``finetune`` CLI and state.npz) against the JAX package.

- Five Adam steps on one fixed batch across an ``sc_step`` boundary equal
  the JAX ``loss_and_grad`` + ``engine.make_optimizer`` steps (float64,
  rtol 1e-9), from the start and resumed from a JAX state.npz.
- A port state.npz loads into the JAX CLI's optax template.
- Fine-tuning changes only the E head and runs no kernel backward; the best
  params track the lowest loss; a resumed run trains only the remaining
  steps; the resample cutoff freezes the batch.
- ``cli train`` / ``cli finetune --device cpu`` write the JAX package's
  files; without ``--device`` they raise on a host without CUDA."""

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.io import checkpoint as jckpt
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
from pinn_for_quantum_wavefunction_surfaces_tpu.ops import sampling as jsam
from pinn_for_quantum_wavefunction_surfaces_tpu.training import engine as jeng
from pinn_for_quantum_wavefunction_surfaces_tpu.training import losses as jlo
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import cli
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
    checkpoint as tckpt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_train as tpt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    sampling as tsam
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    engine as teng
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    losses as tlo

from test_torch_pallas_train import sym_model
from test_torch_sampling_losses import port_cfg, to_port_batch
from test_torch_separable import as_t, no_jax_cache_writes  # noqa: F401


def small_cfg(**train):
    """float64, H = 4, GZ + alpha, the step schedule at sc_step 2."""
    mcfg, _, params = sym_model(1, gz=True, alpha=True, hidden=4)
    jcfg = pqs.smoke_config(dtype="float64")
    kw = dict(epochs=5, n_train=256, scan_chunk=2, lr_schedule="step",
              sc_step=2, sc_decay=0.5, lr=1e-2, resample_frac=1.0)
    kw.update(train)
    jcfg = dataclasses.replace(
        jcfg, model=mcfg, train=dataclasses.replace(jcfg.train, **kw),
        domain=dataclasses.replace(jcfg.domain, box=6.0, bc_cutoff=5.0))
    return jcfg, port_cfg(jcfg), params


@pytest.fixture
def fixed_batch(monkeypatch):
    """Every draw of the port's engine returns one JAX-drawn batch."""
    def use(jcfg):
        batch = jsam.sample_batch(jax.random.PRNGKey(3), jcfg)
        monkeypatch.setattr(teng, "sample_batch",
                            lambda *a, **k: to_port_batch(batch))
        return batch
    return use


_LG = jax.jit(jlo.loss_and_grad, static_argnums=1)


def jax_adam(jcfg, params, batch, steps, save_at=None, save_path=None):
    """The JAX engine's step on a fixed batch: (params, per-step losses)."""
    opt = jeng.make_optimizer(jcfg)
    p = jax.tree.map(jnp.asarray, params)
    state = opt.init(p)
    losses = []
    for i in range(steps):
        if i == save_at:
            jckpt.save(save_path, {"params": p, "opt": state},
                       meta={"step": i})
        loss, _, grads = _LG(p, jcfg, batch)
        losses.append(float(loss))
        updates, state = opt.update(grads, state, p)
        p = optax.apply_updates(p, updates)
    return jax.tree.map(np.asarray, p), np.array(losses)


def assert_params_close(got, want, rtol):
    for k in want:
        for f in want[k]:
            np.testing.assert_allclose(np.asarray(got[k][f]), want[k][f],
                                       rtol=rtol, atol=1e-13,
                                       err_msg=f"{k}/{f}")


def test_adam_steps_and_resume_match_jax(tmp_path, fixed_batch):
    jcfg, tc, params = small_cfg()
    batch = fixed_batch(jcfg)
    state_path = str(tmp_path / "jax_state.npz")
    want, want_losses = jax_adam(jcfg, params, batch, 5, save_at=2,
                                 save_path=state_path)
    res = teng.train(tc, params=params, device="cpu")
    np.testing.assert_allclose(res.history["Ltot"], want_losses, rtol=1e-10)
    assert_params_close(res.params, want, rtol=1e-9)
    # a JAX state.npz (opt/0/count, opt/0/mu/..., opt/1/count) resumes here
    tree, meta = tckpt.load_params(state_path)
    assert meta == {"step": 2}
    res2 = teng.train(tc, params=tree["params"], opt_state=tree["opt"],
                      start_step=2, device="cpu")
    assert len(res2.history["Ltot"]) == 3
    assert_params_close(res2.params, want, rtol=1e-9)
    # and a port state.npz loads into the JAX CLI's template
    path = str(tmp_path / "port_state.npz")
    tckpt.save(path, {"params": res.state.params,
                      "opt": res.state.opt_state}, meta={"step": 5})
    opt = jeng.make_optimizer(jcfg)
    template = {"params": want, "opt": opt.init(
        jax.tree.map(jnp.asarray, want))}
    loaded, meta = jckpt.load(path, template)
    assert meta == {"step": 5}
    assert int(loaded["opt"][0].count) == 5
    assert int(loaded["opt"][1].count) == 5
    np.testing.assert_array_equal(
        loaded["opt"][0].mu["h2"]["w"],
        res.state.opt_state[0]["mu"]["h2"]["w"].numpy())
    assert_params_close(loaded["params"], res.params, rtol=0)


def test_finetune_trains_only_the_e_head(monkeypatch):
    """Frozen K2 inputs: the kernel's backward (the plain adjoint on the
    CPU) is never called in fine-tuning, and once a step in training."""
    _, tc, params = small_cfg(epochs=3, resample_frac=0.0)
    calls = []
    vjp = tpt.psi_lap_train_vjp_plain

    def counted(*a, **k):
        calls.append(1)
        return vjp(*a, **k)

    monkeypatch.setattr(tpt, "psi_lap_train_vjp_plain", counted)
    res = teng.finetune(tc, params=params, device="cpu")
    assert not calls
    for k in params:
        for f in params[k]:
            same = np.array_equal(res.params[k][f], params[k][f])
            assert same == (k not in ("e1", "e2", "eout")), (k, f)
    teng.train(tc, params=params, device="cpu")
    assert len(calls) == 3


def test_best_params_track_the_lowest_loss():
    _, tc, params = small_cfg(epochs=6, lr=0.2, resample_frac=0.0,
                              lr_schedule="none")
    res = teng.train(tc, params=params, device="cpu")
    h = res.history["Ltot"]
    assert res.best_loss == float(np.min(h))
    assert np.argmin(h) < len(h) - 1 or h[-1] == np.min(h)
    best = tans.from_jax_params(res.best_params, device="cpu")
    with torch.no_grad():
        loss, _ = tlo.loss_fn(best, tc, res.state.batch)
    np.testing.assert_allclose(float(loss), res.best_loss, rtol=1e-12)


def test_resume_runs_only_the_remaining_steps():
    _, tc, params = small_cfg(epochs=4)
    res = teng.train(tc, params=params, start_step=3, device="cpu")
    assert len(res.history["Ltot"]) == 1
    done = teng.train(tc, params=params, start_step=4, device="cpu")
    assert len(done.history["Ltot"]) == 0 and done.best_loss == np.inf


def test_resample_cutoff_freezes_the_batch(monkeypatch):
    """epochs 4, resample_frac 0.5: the init draw, then steps 0 and 1
    resample; steps 2 and 3 train on step 1's batch."""
    _, tc, params = small_cfg(epochs=4, resample_frac=0.5)
    draws = []
    draw = tsam.sample_batch

    def counted(*a, **k):
        draws.append(draw(*a, **k))
        return draws[-1]

    monkeypatch.setattr(teng, "sample_batch", counted)
    res = teng.train(tc, params=params, device="cpu")
    assert len(draws) == 3
    gen = torch.Generator().manual_seed(tc.train.seed)
    want = [tsam.sample_batch(gen, tc) for _ in range(3)]
    for got, w in zip(res.state.batch, want[-1]):
        assert torch.equal(got, w)
    assert not torch.equal(want[1].x, want[2].x)


def test_symmetric_init_matches_jax_layout():
    """E-head output bias -1; alpha(R) == 1 and b(R) == 0.1 exactly; same
    keys and shapes as the JAX init."""
    mcfg = pqs.ModelConfig(gz=True, trainable_exponent=True)
    tm = tcfg.ModelConfig(gz=True, trainable_exponent=True)
    jp = jans.init_params(jax.random.PRNGKey(0), mcfg, jnp.float64)
    tp = tans.init_params(tm, seed=0, dtype="float64", device="cpu")
    assert sorted(jp) == sorted(tp)
    for k in jp:
        for f in jp[k]:
            assert tuple(tp[k][f].shape) == jp[k][f].shape, (k, f)
    for k in ("eout", "alpha2", "beta2"):
        np.testing.assert_array_equal(tp[k]["b"].numpy(),
                                      np.asarray(jp[k]["b"]))
    assert float(tp["eout"]["b"]) == -1.0
    r = torch.linspace(0.2, 4.0, 9, dtype=torch.float64)
    a = tans.orbital_exponent(tp, r)
    np.testing.assert_allclose(a.numpy(), 1.0, rtol=1e-15)
    np.testing.assert_allclose(tans.gz_exponent(tp, r, 1, a).numpy(), 0.1,
                               rtol=1e-14)
    bound = 1.0 / np.sqrt(16)
    assert float(tp["h2"]["w"].abs().max()) <= bound


def test_cli_train_and_finetune_write_their_files(tmp_path, capsys):
    out = str(tmp_path / "s1")
    cli.main(["train", "--device", "cpu", "--epochs", "4", "--n-train",
              "512", "--dtype", "float64", "--gz", "--trainable-exponent",
              "--hidden", "4", "--out", out])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"best_loss", "runtime_s", "points_per_sec"}
    assert sorted(os.listdir(out)) == ["best.npz", "final.npz",
                                       "history.pkl", "metrics.jsonl",
                                       "state.npz"]
    with open(os.path.join(out, "history.pkl"), "rb") as f:
        hist = pickle.load(f)
    assert sorted(hist) == ["Energy", "Lbc", "Lpde", "Ltot"]
    assert len(hist["Ltot"]) == 4 and np.isfinite(hist["Ltot"]).all()
    assert jckpt.load_meta(os.path.join(out, "state.npz")) == {"step": 4}
    # the port's best.npz in the JAX reader gives the same psi in JAX
    best, meta = jckpt.load_params(os.path.join(out, "best.npz"))
    assert meta == {"best_loss": summary["best_loss"]}
    mcfg = pqs.ModelConfig(gz=True, trainable_exponent=True, hidden=4)
    rng = np.random.default_rng(4)
    pts = [rng.uniform(-4, 4, 64) for _ in range(3)] + [
        rng.uniform(0.2, 4.0, 64)]
    want, _ = jans.psi(best["params"], mcfg, *pts)
    got, _ = tans.psi(tans.from_jax_params(best["params"], device="cpu"),
                      tcfg.ModelConfig(gz=True, trainable_exponent=True,
                                       hidden=4), *as_t(*pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)

    ft = str(tmp_path / "s2")
    cli.main(["finetune", os.path.join(out, "best.npz"), "--device", "cpu",
              "--epochs", "3", "--n-train", "256", "--dtype", "float64",
              "--gz", "--trainable-exponent", "--hidden", "4", "--out", ft])
    assert "best_loss" in json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(os.listdir(ft)) == ["finetune.npz", "history_finetune.pkl"]
    tuned, _ = jckpt.load_params(os.path.join(ft, "finetune.npz"))
    np.testing.assert_array_equal(tuned["params"]["h2"]["w"],
                                  best["params"]["h2"]["w"])


def test_cli_refuses_what_is_not_ported(tmp_path):
    base = ["train", "--device", "cpu", "--epochs", "1", "--n-train", "64",
            "--out", str(tmp_path)]
    for flags, word in ((["--mesh", "2"], "multi-device"),
                        (["--arch", "minimal"], "minimal"),
                        (["--r-input"], "r_input")):
        with pytest.raises(SystemExit, match=word):
            cli.main(base + flags)
    for flag in ("--kernel", "--remat", "--profile"):
        with pytest.raises(SystemExit):
            cli.main(base + [flag, "x"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["train", "--epochs", "1", "--n-train", "64", "--out",
                      str(tmp_path)])
