"""The 4f pi_u polish (``make excited-4fpiu``) in the port against the
benchmark's plain reference of the excited family
(``portbench/reference/excited.py``: plain torch, autograd laplacian), and
the benchmark's cell of it (``excited-4fpiu.deflated-polish-adam``) on the
CPU at a small size: three R, the dual grid of 6 x 4 and 23 x 17 points,
H 16 as the configuration has it.

- psi and lap psi of the 4f pi_u family (transverse factor y, angular node,
  wide alpha) and of both reference families (2p pi_u; 3p pi_u, a radial
  node), on seeded weights and as shipped, through the quotient's route
  (``routing.psi_lap_rows``: K1's CPU path with its factor epilogue, the
  heads once a row): within 1e-12 of
  the largest |value| (psi and lap psi vanish on the nodes, so a pointwise
  relative tolerance is no test there);
- the deflated objective (``variational.polish_objective`` against the two
  shipped references): the loss rtol 1e-11, each leaf's gradient within
  1e-8 of its largest entry (the tolerances of test_torch_excited.py's
  deflation tests);
- a planted fault fails that comparison: the reference without the
  transverse factor or without the angular node;
- the excited layout the cell completes from the harness's ground draw has
  the leaves of ``ansatz.init_params`` for the configuration's model;
- the cell's first steps against the reference (``correct``), and a step
  that is broken (Adam leaves the state unchanged, half of each row left
  out) or the reference in float32 put in the program's place is not
  correct;
- the tracing: a deflated step's phases are forward, deflate, backward and
  update in that order, the flagship's step has no deflate phase;
  ``routing.fwdlap_points`` counts nothing a step, deflated or not (the
  excited family takes K1), and ``head_evals`` counts its rows, a
  captured step's replays too; ``pinn.references`` spans the references'
  rows, which go through K1 at every point (the flat entry);
- ``polish_spheroidal`` through ``polish_objective`` takes the same steps,
  bit for bit, as the objective wired by hand, with and without
  references.

torch runs on one thread (see test_torch_excited.py)."""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    routing as trt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    graphs
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    variational as tvar
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.utils import profiling
from portbench import check, harness, program, weights
from portbench.mixes import deflated_warmup
from portbench.reference import excited

from test_torch_excited import one_torch_thread  # noqa: F401
from test_torch_graphs import StubGraph

CELL = "excited-4fpiu.deflated-polish-adam"
ROOT = os.path.join(os.path.dirname(__file__), "..")
with open(os.path.join(ROOT, "portbench", "configs",
                       "excited-4fpiu.json")) as _f:
    CFG = json.load(_f)
MODEL = CFG["model"]
SMALL = {"n_r": 3, "n_xi": 6, "n_eta": 4, "read_every": 2}
SEED = 2 ** 31 + 4242
FAMILIES = {"4fpiu": dict(eta_node=True),
            "2ppu": dict(eta_node=False),
            "3ppu": dict(eta_node=False, xi_node=True)}
SHIPPED = {"2ppu": 0, "3ppu": 1}


def config(**factors):
    """float64 Config of the configuration's model with ``factors``."""
    return tcfg.Config(model=tcfg.ModelConfig(**{**MODEL, **factors}),
                       domain=tcfg.DomainConfig(**CFG["domain"]),
                       dtype="float64")


def seeded(cfg, seed=3):
    """The family's init with the output layers of the correction and of
    every head drawn N(0, 0.3^2), so that every factor shapes psi."""
    params = tans.init_params(cfg.model, seed=seed, dtype="float64",
                              device="cpu")
    gen = torch.Generator().manual_seed(seed + 10)
    for name in ("lamout", "muout", "xalpha2", "beta2", "rnode2", "enode2"):
        if name in params:
            params[name]["w"] = 0.3 * torch.randn(
                params[name]["w"].shape, generator=gen, dtype=torch.float64)
    return params


def shipped():
    """The two shipped references of the configuration, as port params."""
    return [tans.as_params(t, torch.float64, "cpu")
            for t in deflated_warmup.references(CFG)]


def batch(cfg):
    return tvar.dual_grid_vbatch(cfg, SMALL["n_r"], SMALL["n_xi"],
                                 SMALL["n_eta"], device="cpu")


def flat_points(vb):
    n_r, n_pts = vb.x.shape
    return (vb.x.reshape(-1), vb.y.reshape(-1), vb.z.reshape(-1),
            vb.r[:, None].expand(n_r, n_pts).reshape(-1))


def gap(got, want) -> float:
    """The largest |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max())


def port_rows(params, cfg, vb):
    psi, lap = trt.psi_lap_rows(params, cfg.model, vb.x, vb.y, vb.z, vb.r)
    return psi.detach(), lap.detach()


CASES = [(f, None) for f in FAMILIES] + [(f, i) for f, i in SHIPPED.items()]


@pytest.mark.parametrize("family,ref", CASES,
                         ids=[f if i is None else f + "-shipped"
                              for f, i in CASES])
def test_psi_and_lap_match_the_reference(family, ref):
    cfg = config(**FAMILIES[family])
    params = seeded(cfg) if ref is None else shipped()[ref]
    assert trt.kernel_of(params, cfg.model) == "K1"
    vb = batch(cfg)
    psi, lap = port_rows(params, cfg, vb)
    want_psi, want_lap = excited.psi_lap(params, *flat_points(vb),
                                         MODEL["m_abs"])
    assert gap(psi, want_psi.detach()) <= 1e-12
    assert gap(lap, want_lap.detach()) <= 1e-12


def deflated(cfg, params, vb, hw=0.7):
    """(loss, {leaf: grad}) of the port's deflated objective."""
    p = {k: {f: t.detach().clone().requires_grad_(True)
             for f, t in v.items()} for k, v in params.items()}
    loss, _ = tvar.polish_objective(cfg, vb, shipped())(p, cfg, vb, hw)
    loss.backward()
    return loss.item(), {(k, f): t.grad for k, v in p.items()
                         for f, t in v.items()}


def reference_loss(params, vb, hw=0.7, m=MODEL["m_abs"]):
    p = {k: {f: t.detach().clone().requires_grad_(True)
             for f, t in v.items()} for k, v in params.items()}
    loss, grads = excited.quotient_deflated(p, tuple(vb), shipped(), m, hw)
    keys = [(k, f) for k in sorted(params) for f in sorted(params[k])]
    return loss, dict(zip(keys, grads))


def test_the_deflated_objective_matches_the_reference():
    cfg = config()
    params = seeded(cfg)
    vb = batch(cfg)
    loss, grads = deflated(cfg, params, vb)
    want, want_grads = reference_loss(params, vb)
    assert loss == pytest.approx(want, rel=1e-11, abs=0)
    assert set(grads) == set(want_grads)
    nonzero = 0
    for kf, g in grads.items():
        w = want_grads[kf]
        assert float((g - w).abs().max()) <= 1e-8 * max(
            float(w.abs().max()), 1e-300), kf
        nonzero += bool(w.any())
    # every leaf shapes the loss at these weights
    assert nonzero == len(grads)


def without_enode(params):
    return {k: v for k, v in params.items() if not k.startswith("enode")}


@pytest.mark.parametrize("fault", ["transverse", "eta_node"])
def test_a_planted_fault_fails_the_comparison(fault):
    cfg = config()
    params = seeded(cfg)
    vb = batch(cfg)
    m = MODEL["m_abs"]
    broken, bm = ((params, 0) if fault == "transverse"
                  else (without_enode(params), m))
    psi, lap = port_rows(params, cfg, vb)
    want_psi, want_lap = excited.psi_lap(broken, *flat_points(vb), bm)
    assert gap(psi, want_psi.detach()) > 1e-3
    assert gap(lap, want_lap.detach()) > 1e-3
    loss, _ = deflated(cfg, params, vb)
    want, _ = reference_loss(broken, vb, m=bm)
    assert abs(loss - want) > 1e-6 * abs(want)


def test_the_completed_layout_is_the_families():
    ground = weights.make(MODEL, SEED, torch.float64, "cpu")
    done = deflated_warmup.complete(ground, MODEL, SEED)
    init = tans.init_params(tcfg.ModelConfig(**MODEL), dtype="float64",
                            device="cpu")
    assert {(k, f): tuple(t.shape) for k, v in done.items()
            for f, t in v.items()} == \
        {(k, f): tuple(t.shape) for k, v in init.items() for f, t in v.items()}
    # the drawn alpha layer is kept; the new output layers give alpha = 1
    # and eta0^2 = 1/3
    assert torch.equal(done["xalpha1"]["w"], ground["alpha1"]["w"])
    r = torch.tensor([0.2, 1.0, 4.0], dtype=torch.float64)
    torch.testing.assert_close(tans.orbital_exponent(done, r),
                               torch.ones_like(r), rtol=1e-15, atol=0)
    torch.testing.assert_close(tans.node_eta0sq(done, r),
                               torch.full_like(r, 1.0 / 3.0), rtol=1e-15,
                               atol=0)
    # the seed permutes the angular node's units, one draw's values
    other = deflated_warmup.complete(
        weights.make(MODEL, SEED + 1, torch.float64, "cpu"), MODEL, SEED + 1)
    a, b = done["enode1"]["w"].flatten(), other["enode1"]["w"].flatten()
    assert not torch.equal(a, b)
    assert torch.equal(a.sort().values, b.sort().values)
    again = deflated_warmup.complete(ground, MODEL, SEED)
    assert torch.equal(again["enode1"]["b"], done["enode1"]["b"])


def small_cell():
    c = harness.resolve(CELL, harness.benchmark())
    c.traffic.update(SMALL)
    return c


def test_the_reference_follows_the_cell():
    c = small_cell()
    mix, rec, start = harness.program_record(c, SEED, "cpu")
    assert (mix.points, mix.kernel_points, mix.rows) == (
        3 * (6 * 4 + 23 * 17), 6 * 23 * 17, 6)
    ref = harness.reference_record(c, SEED, start, "cpu")
    assert sorted(rec["grad"]) == sorted(ref["grad"]) == [
        f"{k}/{f}" for k in sorted(mix.start) for f in ("b", "w")]
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
    """The deflated objective sees the first half of each row."""
    v = program.module("training.variational")
    real = v.quotient_loss_deflated

    def q(params, cfg, vb, psi0, hpsi0, *a, **k):
        n = vb.x.shape[1] // 2
        return real(params, cfg, v.VBatch(*(t[:, :n] for t in vb[:4]), vb.r),
                    psi0[..., :n], hpsi0[..., :n], *a, **k)

    monkeypatch.setattr(v, "quotient_loss_deflated", q)


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


def warmup(deflate: bool):
    """An Adam warmup on the small dual grid: the 4f pi_u family against
    the shipped references, or the flagship's ground family (K1's route)."""
    cfg = config() if deflate else tcfg.Config(
        model=tcfg.ModelConfig(arch="separable"), dtype="float64")
    params = seeded(cfg) if deflate else tans.init_params(
        cfg.model, seed=1, dtype="float64", device="cpu")
    vb = batch(cfg)
    loss_fn = tvar.polish_objective(cfg, vb, shipped() if deflate else None)
    return tvar.AdamWarmup(params, cfg, vb, 8, 1.0, loss_fn=loss_fn), vb


@pytest.mark.parametrize("deflate", [True, False])
def test_the_deflated_step_marks_its_deflate_phase(deflate, tracing_off):
    warm, _ = warmup(deflate)
    warm.advance()
    assert warm.phases() == {}
    profiling.enable(True)
    warm.advance()
    names = [m[0] for m in warm._step.marks]
    want = ["forward", "deflate", "backward", "update"] if deflate else \
        ["forward", "backward", "update"]
    assert names == want + [None]
    assert list(warm.phases()) == want


class Recording(graphs.StepGraph):
    """StepGraph with stub graphs: a capture runs the step as Python (the
    counters see it) and its replays run nothing, so the counts of a replay
    come from ``routing.COUNTERS`` alone."""

    def eager(self):
        self._run()

    def record(self):
        self._run()
        return StubGraph()


@pytest.mark.parametrize("deflate", [True, False])
def test_fwdlap_points_count_a_step_and_its_replays(deflate):
    warm, vb = warmup(deflate)
    n_r, n_pts = vb.x.shape
    fw, heads = dict(trt.fwdlap_points), dict(trt.head_evals)
    warm.advance()
    assert trt.fwdlap_points == fw
    assert trt.head_evals == {"rows": heads["rows"] + n_r,
                              "points": heads["points"]}
    # captured: one eager step, a capture, then replays of nothing
    warm._step = Recording(warm._eval_and_update, capture=True)
    fw, heads = dict(trt.fwdlap_points), dict(trt.head_evals)
    for _ in range(4):
        warm.advance()
    assert trt.fwdlap_points == fw
    assert trt.head_evals["rows"] == heads["rows"] + 4 * n_r


def test_the_references_rows_are_counted_and_spanned(tracing_off):
    cfg = config()
    vb = batch(cfg)
    fw, heads = dict(trt.fwdlap_points), dict(trt.head_evals)
    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tvar.polish_objective(cfg, vb, shipped())
    names = [e.name for e in prof.events()
             if e.name.startswith(profiling.SPAN)]
    assert names == ["pinn.references"]
    # both references through K1's factor epilogue, heads at every point
    assert trt.fwdlap_points == fw
    assert trt.head_evals["points"] == heads["points"] + 2 * vb.x.numel()


def hand_wired(params, cfg, deflate, n_r, n_xi, n_eta, adam, lbfgs):
    """The polish as its objective was wired inside ``polish_spheroidal``
    before ``polish_objective``: the references' rows computed on the
    training and on the validation grid, quotient_loss_deflated (or
    quotient_loss) closed over them."""
    dt, dev = torch.float64, torch.device("cpu")
    params = tans.as_params(params, dt, dev)
    vb = tvar.dual_grid_vbatch(cfg, n_r, n_xi, n_eta, None, dt, dev)

    def loss_fn(p, cfg_, vb_, hw):
        return tvar.quotient_loss(p, cfg_, vb_, hw)
    frozen = None
    if deflate is not None:
        frozen = [tans.as_params(p, dt, dev) for p in deflate]
        psi0, hpsi0 = tvar.reference_states_on_batch(frozen, cfg, vb)

        def loss_fn(p, cfg_, vb_, hw):
            return tvar.quotient_loss_deflated(p, cfg_, vb_, psi0, hpsi0, hw)
    vbv = tvar.validation_vbatch(cfg, n_r, n_xi, n_eta, True, None, dt, dev)
    if frozen is not None:
        psi0v, hpsi0v = tvar.reference_states_on_batch(frozen, cfg, vbv)

        def val_fn(p):
            return tvar.quotient_loss_deflated(p, cfg, vbv, psi0v, hpsi0v,
                                               1.0)[0]
    else:
        def val_fn(p):
            return tvar.quotient_loss(p, cfg, vbv, 1.0)[0]
    params = tvar._adam_minimize(params, cfg, vb, adam, 1.0, loss_fn=loss_fn,
                                 graph=False)
    return tvar._lbfgs_minimize(params, cfg, vb, lbfgs, 1.0, None,
                                loss_fn=loss_fn, val_fn=val_fn)


@pytest.mark.parametrize("deflate", [True, False])
def test_polish_spheroidal_is_the_hand_wired_polish(deflate):
    cfg = config() if deflate else tcfg.Config(
        model=tcfg.ModelConfig(arch="separable"), dtype="float64")
    params = seeded(cfg) if deflate else tans.init_params(
        cfg.model, seed=1, dtype="float64", device="cpu")
    refs = deflated_warmup.references(CFG) if deflate else None
    got = tvar.polish_spheroidal(params, cfg, n_r=2, n_xi=6, n_eta=4,
                                 steps=2, adam_steps=3, deflate_params=refs,
                                 device="cpu", graph=False)
    want = hand_wired(params, cfg, refs, 2, 6, 4, 3, 2)
    assert sorted(got) == sorted(want)
    for k in want:
        for f in want[k]:
            assert torch.equal(got[k][f], want[k][f]), (k, f)
    moved = any(not torch.equal(got[k][f], params[k][f].to(got[k][f]))
                for k in got for f in got[k])
    assert moved
