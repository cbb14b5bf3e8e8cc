"""The paper's own network (the reference code's poc/main.py; ``make
ref-recipe``'s ``config.paper_config()``) in the port against the
benchmark's plain reference of it (``portbench/reference/poc.py``: plain
torch, autograd laplacian), and the benchmark's cell of it
(``paper-poc.train-f64``) on the CPU at a small size: the configuration's
widths, 1 024 points.

- psi and lap psi through the residual's route (``routing.psi_lap``: K2's
  CPU path with the R-heads pair's plain versions, alpha and b widths 0),
  on seeded weights and on the shipped ``artifacts/flagship_model.bin``
  read by ``io/modelbin``: within 1e-12 of the largest |value| (the
  correction changes sign, so a pointwise relative tolerance is no test
  there), E(R) alike;
- the residual loss (``losses.loss_fn``) rtol 1e-11, each leaf's gradient
  within 1e-8 of its largest entry (the tolerances of
  test_torch_excited_4fpiu.py);
- a planted fault fails those comparisons: the reference with a GZ part,
  with alpha(R) switched on, or without the mirrored branch;
- the tree the cell strips from the harness's draw has exactly the leaves
  of ``ansatz.init_params(ModelConfig())``, and the configuration's model
  is ``paper_config()``'s;
- the cell's first steps through ``harness.run`` are correct; a broken step
  (Adam leaves the state unchanged, half of each batch left out) or the
  reference in float32 put in the program's place is not;
- the tracing and the counters: a step's phases are sample, forward,
  backward and update in that order; each step counts its points in
  ``routing.head_evals`` and none in ``fwdlap_points``, a captured step's
  replays too; no launch is counted on the CPU.

torch runs on one thread (see test_torch_excited.py)."""

import json
import os

import pytest
import torch

from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import modelbin
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    pallas_train as tpt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    rheads as trh
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    routing as trt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    sampling as tsamp
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    losses as tloss
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.utils import profiling
from portbench import check, harness, program, weights
from portbench.mixes import poc_residual
from portbench.reference import ansatz as ref_ansatz
from portbench.reference import poc

from test_torch_excited import one_torch_thread  # noqa: F401
from test_torch_excited_4fpiu import Recording

CELL = "paper-poc.train-f64"
ROOT = os.path.join(os.path.dirname(__file__), "..")
with open(os.path.join(ROOT, "portbench", "configs", "paper-poc.json")) as _f:
    CFG = json.load(_f)
MODEL = CFG["model"]
N = 1024
SMALL = {"read_every": 4, "train": {"n_train": N}}
SEED = 2 ** 31 + 2611


def config():
    return tcfg.paper_config(domain=tcfg.DomainConfig(**CFG["domain"]),
                             dtype="float64")


def seeded(seed=3):
    return tans.init_params(config().model, seed=seed, dtype="float64",
                            device="cpu")


def shipped():
    return tans.as_params(
        modelbin.load_params(os.path.join(ROOT, "artifacts",
                                          "flagship_model.bin")),
        torch.float64, "cpu")


WEIGHTS = {"seeded": seeded, "shipped": shipped}


def batch(seed=0):
    return tsamp.sample_batch(torch.Generator().manual_seed(seed), config(),
                              n=N, device="cpu")


def gap(got, want) -> float:
    """The largest |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max())


def port_psi_lap(params, b):
    psi, lap, e = trt.psi_lap(params, config().model, b.x, b.y, b.z, b.r)
    return psi.detach(), lap.detach(), e.detach()


@pytest.mark.parametrize("which", list(WEIGHTS))
def test_psi_and_lap_match_the_reference(which):
    params = WEIGHTS[which]()
    cfg = config()
    assert trt.kernel_of(params, cfg.model) == "K2"
    b = batch()
    psi, lap, e = port_psi_lap(params, b)
    want_psi, want_lap = poc.psi_lap(params, b.x, b.y, b.z, b.r)
    assert gap(psi, want_psi.detach()) <= 1e-12
    assert gap(lap, want_lap.detach()) <= 1e-12
    assert gap(e, ref_ansatz.energy(params, b.r)) <= 1e-12


def port_loss(params, b):
    """(loss, {leaf: grad}) of the port's residual objective."""
    p = {k: {f: t.detach().clone().requires_grad_(True)
             for f, t in v.items()} for k, v in params.items()}
    loss, _ = tloss.loss_fn(p, config(), b)
    loss.backward()
    return loss.item(), {(k, f): t.grad for k, v in p.items()
                         for f, t in v.items()}


def reference_loss(params, pts, **variant):
    p = {k: {f: t.detach().clone().requires_grad_(True)
             for f, t in v.items()} for k, v in params.items()}
    loss, grads = poc.residual(p, tuple(pts), **variant)
    keys = [(k, f) for k in sorted(params) for f in sorted(params[k])]
    return loss, dict(zip(keys, grads))


@pytest.mark.parametrize("which", list(WEIGHTS))
def test_the_residual_loss_matches_the_reference(which):
    params = WEIGHTS[which]()
    b = batch(1)
    loss, grads = port_loss(params, b)
    want, want_grads = reference_loss(params, b)
    assert loss == pytest.approx(want, rel=1e-11, abs=0)
    assert set(grads) == set(want_grads)
    for kf, g in grads.items():
        w = want_grads[kf]
        assert w.abs().max() > 0, kf      # every leaf shapes the loss
        assert float((g - w).abs().max()) <= 1e-8 * float(w.abs().max()), kf


def planted(fault, r):
    """The reference's variant of a planted fault at the half-distances
    ``r``: the GZ family's b(R) at its init (0.1), an alpha(R) head whose
    output layer is drawn N(0, 0.5^2), or no mirrored branch."""
    if fault == "mirror":
        return {"mirror": False}
    heads = tans.init_params(tcfg.ModelConfig(gz=True,
                                              trainable_exponent=True),
                             seed=5, dtype="float64", device="cpu")
    heads["alpha2"]["w"] = 0.5 * torch.randn(
        heads["alpha2"]["w"].shape, generator=torch.Generator().manual_seed(6),
        dtype=torch.float64)
    alpha, b = ref_ansatz.exponents(heads, r)
    return {"b": b} if fault == "gz" else {"alpha": alpha}


@pytest.mark.parametrize("fault", ["gz", "alpha", "mirror"])
def test_a_planted_fault_fails_the_comparison(fault):
    params = seeded()
    b = batch(2)
    variant = planted(fault, b.r)
    psi, lap, _ = port_psi_lap(params, b)
    want_psi, want_lap = poc.psi_lap(params, b.x, b.y, b.z, b.r, **variant)
    assert gap(psi, want_psi.detach()) > 1e-3
    assert gap(lap, want_lap.detach()) > 1e-3
    loss, _ = port_loss(params, b)
    want, _ = reference_loss(params, b, **variant)
    assert abs(loss - want) > 1e-6 * abs(want)


def test_the_stripped_tree_is_the_papers():
    assert tcfg.ModelConfig(**MODEL) == tcfg.paper_config().model
    drawn = weights.make(MODEL, SEED, torch.float64, "cpu")
    assert set(poc_residual.HEADS) <= set(drawn)
    tree = poc_residual.strip(drawn)
    init = tans.init_params(tcfg.ModelConfig(), dtype="float64", device="cpu")
    assert {(k, f): tuple(t.shape) for k, v in tree.items()
            for f, t in v.items()} == \
        {(k, f): tuple(t.shape) for k, v in init.items() for f, t in v.items()}
    # the leaves it keeps are the draw's own
    assert all(tree[k] is drawn[k] for k in tree)
    assert trt.kernel_of(tree, tcfg.ModelConfig(**MODEL)) == "K2"
    assert trt.kernel_of(tree, tcfg.ModelConfig(**MODEL),
                         forward_only=True) == "K3"


def small_cell():
    c = harness.resolve(CELL, harness.benchmark())
    for k, v in SMALL.items():
        c.traffic[k] = {**c.traffic[k], **v} if isinstance(v, dict) else v
    return c


def test_the_reference_follows_the_cell():
    c = small_cell()
    mix, rec, start = harness.program_record(c, SEED, "cpu")
    assert (mix.points, mix.kernel_points) == (N, N)
    assert sorted(mix.tr.layout.tree(mix.tr.flat)) == sorted(
        poc_residual.strip(start))
    ref = harness.reference_record(c, SEED, start, "cpu")
    assert sorted(rec["grad"]) == sorted(ref["grad"]) == [
        f"{k}/{f}" for k in sorted(poc_residual.strip(start))
        for f in ("b", "w")]
    g = check.gaps(rec, ref)
    ok, checks = check.decide(g, c.limits)
    assert ok, checks
    assert g["loss"] < 1e-13 and g["grad"] < 1e-12, g


def test_a_run_of_the_cell_on_the_cpu_is_correct():
    res, checks = harness.run(small_cell(), SEED + 1, 0.3, False, "cpu",
                              log=lambda *a, **k: None)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"points_per_s", "setup_s"}


def unchanged(monkeypatch):
    """Adam leaves the params where they are."""
    monkeypatch.setattr(program.module("training.engine").Adam, "step",
                        lambda self, grad: None)


def half_batch(monkeypatch):
    """The trainer's loss sees the first half of each batch."""
    engine = program.module("training.engine")
    loss = engine.Trainer.loss

    def half(params, cfg, b, *a, **k):
        n = b.x.shape[0] // 2
        return loss(params, cfg, type(b)(*(t[:n] for t in b)), *a, **k)

    monkeypatch.setattr(engine.Trainer, "loss", staticmethod(half))


@pytest.mark.parametrize("fault", [unchanged, half_batch])
def test_a_broken_step_of_the_cell_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res, checks = harness.run(small_cell(), SEED + 2, 0.3, False, "cpu",
                              log=lambda *a, **k: None)
    assert res["correct"] is False, checks


def test_the_float32_reference_of_the_cell_is_not_correct():
    c = small_cell()
    start = weights.make(c.config["model"], SEED + 3, torch.float64, "cpu")
    ref = harness.reference_record(c, SEED + 3, start, "cpu")
    ctl = harness.reference_record(c, SEED + 3, start, "cpu", torch.float32)
    ok, checks = check.decide(check.gaps(ctl, ref), c.limits)
    assert not ok, checks


@pytest.fixture
def tracing_off():
    profiling.enable(False)
    yield
    profiling.enable(False)


def test_a_step_marks_its_phases(tracing_off):
    mix, _, _ = harness.program_record(small_cell(), SEED + 4, "cpu")
    mix.step()
    assert mix.tr.phases() == {}
    profiling.enable(True)
    mix.step()
    assert list(mix.tr.phases()) == ["sample", "forward", "backward",
                                     "update"]


def test_the_counters_of_a_step_and_its_replays():
    mix, _, _ = harness.program_record(small_cell(), SEED + 5, "cpu")
    launches = (dict(tpt.launches), dict(trh.launches))
    fw, heads = dict(trt.fwdlap_points), dict(trt.head_evals)
    mix.step()
    mix.read()
    assert trt.head_evals == {"rows": heads["rows"],
                              "points": heads["points"] + N}
    # captured: one eager step, a capture, then replays of nothing
    mix.tr._step = Recording(mix.tr._train_step, capture=True)
    for _ in range(4):
        mix.step()
    mix.read()
    assert trt.head_evals["points"] == heads["points"] + 5 * N
    assert trt.head_evals["rows"] == heads["rows"]
    assert trt.fwdlap_points == fw
    # the plain path launches nothing; the card's counts are 1 + 1 K2 and
    # 1 + 1 R-heads launches a step (chip_smoke.py phase 26)
    assert (dict(tpt.launches), dict(trh.launches)) == launches
