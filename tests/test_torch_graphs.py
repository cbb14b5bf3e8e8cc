"""The graph-ready training steps of the PyTorch port on the CPU: what a
CUDA graph capture needs of them, and what the capture helper does
(training/graphs.py), without a card.

- The three steps (``engine.Trainer``, ``variational.MonteCarloTrainer``,
  ``variational.AdamWarmup``) keep their buffers: across their steps the
  ``data_ptr()`` of the params, Adam's moments, best, EMA, batch and
  history row do not change, while their values do.
- ``StepGraph``: the first call eager, the second captures and replays,
  every later call replays; the launch counts gain the capture's launches
  once a replay (a stub graph); a capture that raises propagates, with no
  eager step in its place; a capture runs with the cyclic collector
  paused; ``captures`` decides the route.
- A run whose captures are stubs that replay the recorded step on the CPU
  equals the eager run bit for bit (``train``, ``finetune``,
  ``train_variational``, ``_adam_minimize``), with one replay a step after
  the first and one a resample after the first: the host's control flow
  around the graphs (resample schedule, rate, history rows).
- ``routing.head_evals``: a quotient step (Monte-Carlo, Adam warmup) adds
  its R rows, a residual step its points, a captured step's replays what
  its eager steps add.
- The capturable ``Adam`` equals optax.adam on the same gradients under
  the staircase schedule, to a few units in the last place.

torch runs on one thread (see test_torch_excited.py)."""

import contextlib
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    routing
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    sampling as tsam
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    engine as teng
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    graphs
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    variational as tvar

from test_torch_excited import one_torch_thread  # noqa: F401
from test_torch_separable import no_jax_cache_writes  # noqa: F401


def train_cfg(arch="symmetric", **train):
    """float64, H = 4, a small box; GZ + alpha for the symmetric family."""
    model = (tcfg.ModelConfig(arch="separable", hidden=4)
             if arch == "separable" else
             tcfg.ModelConfig(hidden=4, hidden_e=8, hidden_gate=4, gz=True,
                              trainable_exponent=True))
    kw = dict(n_train=128, epochs=9, scan_chunk=4, lr_schedule="step",
              sc_step=3, sc_decay=0.5, lr=1e-2, resample_every=2,
              resample_frac=0.6, ema_decay=0.5)
    kw.update(train)
    return tcfg.Config(model=model, dtype="float64",
                       domain=tcfg.DomainConfig(box=6.0, bc_cutoff=5.0),
                       train=tcfg.TrainConfig(**kw))


def ptrs(*tensors) -> list[int]:
    return [t.data_ptr() for t in tensors]


def snapshot(*tensors) -> list[torch.Tensor]:
    return [t.detach().clone() for t in tensors]


def assert_kept_and_moved(step, buffers, moved):
    """``buffers()`` after each of 4 more steps sit where they sat after
    the first; each tensor of ``moved()`` took new values."""
    where = ptrs(*buffers())
    before = snapshot(*moved())
    for _ in range(4):
        step()
        assert ptrs(*buffers()) == where
    for old, new in zip(before, moved()):
        assert not torch.equal(old, new)


def test_trainer_keeps_its_buffers():
    cfg = train_cfg(resample_every=1, resample_frac=1.0)
    gen = torch.Generator().manual_seed(0)
    tr = teng.Trainer(cfg, device="cpu", generator=gen)

    def sample(g):
        return tsam.sample_batch(g, cfg, device="cpu")

    tr.batch = sample(gen)
    tr.advance(sample)

    def buffers():
        return (tr.flat, tr.opt.mu, tr.opt.nu, tr.opt.count, tr.opt.lr,
                tr.best_flat, tr.best_loss, tr.ema_flat, tr.row, *tr.batch)

    assert_kept_and_moved(
        lambda: tr.advance(sample), buffers,
        lambda: (tr.flat, tr.opt.mu, tr.ema_flat, tr.row, tr.batch.x))
    # every leaf of the state is a view of the live vectors
    st = tr.state()
    assert st.params["h1"]["w"].data_ptr() >= tr.flat.data_ptr()
    assert st.best_loss is tr.best_loss and st.batch is tr.batch


def test_monte_carlo_trainer_keeps_its_buffers():
    cfg = train_cfg("separable")
    params = tans.init_params(cfg.model, seed=1, dtype="float64",
                              device="cpu")
    mc = tvar.MonteCarloTrainer(cfg, params, 2, 64,
                                torch.Generator().manual_seed(3),
                                antithetic=True, stratified=True,
                                device="cpu")
    mc.advance()

    def buffers():
        return (mc.flat, mc.opt.mu, mc.opt.nu, mc.ema_flat, mc.row,
                *mc.vb)

    assert_kept_and_moved(mc.advance, buffers,
                          lambda: (mc.flat, mc.ema_flat, mc.row, mc.vb.x))


def test_adam_warmup_keeps_its_buffers():
    cfg = train_cfg("separable")
    params = tans.init_params(cfg.model, seed=1, dtype="float64",
                              device="cpu")
    vb = tvar.dual_grid_vbatch(cfg, 2, 8, 6, device="cpu")
    warm = tvar.AdamWarmup(params, cfg, vb, 5, 1.0)
    warm.advance()

    def buffers():
        return (warm.flat, warm.opt.mu, warm.opt.nu, warm.loss)

    assert_kept_and_moved(warm.advance, buffers,
                          lambda: (warm.flat, warm.loss))


# ---------------------------------------------------------------------------
# StepGraph with stub graphs


class StubGraph:
    """A captured step on the CPU: its replay runs the recorded function
    (or nothing, when ``run`` is None)."""

    def __init__(self, run=None):
        self.run, self.replays = run, 0

    def replay(self):
        self.replays += 1
        if self.run is not None:
            self.run()


class CpuStepGraph(graphs.StepGraph):
    """StepGraph with the CUDA parts stubbed: the eager call runs ``fn``
    here, a capture records nothing (its graph replays ``fn``), and every
    graph made is kept in ``made``."""

    made: list = []

    def eager(self):
        self.fn()

    def record(self):
        g = StubGraph(self.fn)
        CpuStepGraph.made.append(g)
        return g


def test_step_graph_adds_the_captured_launches_once_a_replay():
    counts = {"train_fwd": 0, "train_bwd": 0, "train_bwd_pg": 0}
    calls = []

    def fn():
        # as a wrapper counts its launch, at the eager call and while a
        # capture records it
        calls.append(len(calls))
        counts["train_fwd"] += 1
        counts["train_bwd"] += 1

    graph = StubGraph()

    class Stub(graphs.StepGraph):
        def eager(self):
            self.fn()

        def record(self):
            self.fn()
            return graph

    step = Stub(fn, capture=True, counters=(counts,))
    for _ in range(5):
        step()
    # one eager call and one capture ran fn; calls 2-5 replayed
    assert len(calls) == 2 and graph.replays == 4
    assert step.per_replay == [{"train_fwd": 1, "train_bwd": 1,
                                "train_bwd_pg": 0}]
    assert counts == {"train_fwd": 5, "train_bwd": 5, "train_bwd_pg": 0}


def test_step_graph_raises_a_failed_capture_and_runs_nothing_eager():
    calls = []

    class Refused(graphs.StepGraph):
        def eager(self):
            self.fn()

        def record(self):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    step = Refused(lambda: calls.append(1), capture=True, counters=())
    step()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            step()
    assert calls == [1] and step.graph is None


def test_step_graph_captures_with_the_cyclic_collector_paused(monkeypatch):
    # an earlier trainer's graph freed by a collection inside a capture
    # would end the capture on the card; record() pauses the collector
    seen = []

    class Graph:
        def register_generator_state(self, gen):
            pass

    @contextlib.contextmanager
    def capture(graph, stream=None):
        seen.append(("enter", gc.isenabled()))
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    step = graphs.StepGraph(lambda: seen.append(("fn", gc.isenabled())),
                            capture=True, counters=())
    step._stream = object()
    assert gc.isenabled()
    assert isinstance(step.record(), Graph)
    assert seen == [("enter", False), ("fn", False)] and gc.isenabled()
    gc.disable()
    try:
        step.record()
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_step_graph_without_capture_runs_every_call_eagerly():
    calls = []

    class NoCuda(graphs.StepGraph):
        def eager(self):
            raise AssertionError("the eager route takes no side stream")

        def record(self):
            raise AssertionError("the eager route captures nothing")

    step = NoCuda(lambda: calls.append(1), capture=False)
    for _ in range(3):
        step()
    assert calls == [1, 1, 1]


@pytest.mark.parametrize("device, mesh, graph, want", [
    ("cuda", None, True, True), (torch.device("cuda:0"), None, True, True),
    ("cuda", object(), True, False), ("cuda", None, False, False),
    ("cpu", None, True, False), ("cpu", object(), True, False)])
def test_captures_on_cuda_without_a_mesh(device, mesh, graph, want):
    assert graphs.captures(device, mesh, graph) is want


@pytest.fixture
def stub_captures(monkeypatch):
    """Every trainer without a mesh captures unless given graph=False, as
    on a card, its graphs CpuStepGraph's stubs; returns the list of graphs
    made."""
    CpuStepGraph.made = []
    monkeypatch.setattr(graphs, "StepGraph", CpuStepGraph)
    monkeypatch.setattr(graphs, "captures",
                        lambda device, mesh=None, graph=True:
                        bool(graph) and mesh is None)
    return CpuStepGraph.made


def assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        for f in a[k]:
            np.testing.assert_array_equal(a[k][f], b[k][f], err_msg=k + f)


def assert_results_equal(a, b):
    for k in b.history:
        np.testing.assert_array_equal(a.history[k], b.history[k])
    assert_trees_equal(a.params, b.params)
    assert_trees_equal(a.best_params, b.best_params)
    assert_trees_equal(a.ema_params, b.ema_params)
    assert a.best_loss == b.best_loss


def test_stub_captured_train_and_finetune_equal_eager(stub_captures):
    cfg = train_cfg()
    eager = teng.train(cfg, device="cpu", graph=False)
    assert not stub_captures
    got = teng.train(cfg, device="cpu")
    assert_results_equal(got, eager)
    for a, b in zip(got.state.batch, eager.state.batch):
        assert torch.equal(a, b)
    # the step graph, then the sampler's: resamples at steps 0, 2 and 4
    # (step < 0.6 * 9), one eager, two replayed; 9 steps, one eager
    assert [g.replays for g in stub_captures] == [8, 2]
    ft_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=4))
    ft_eager = teng.finetune(ft_cfg, eager.params, device="cpu",
                             graph=False)
    ft = teng.finetune(ft_cfg, eager.params, device="cpu")
    assert_results_equal(ft, ft_eager)


def test_stub_captured_monte_carlo_and_warmup_equal_eager(stub_captures):
    cfg = train_cfg("separable", scan_chunk=3, lr_schedule="none")
    params = tans.init_params(cfg.model, seed=1, dtype="float64",
                              device="cpu")

    def mc(graph):
        return tvar.train_variational(
            cfg, params, n_r=2, n_pts=64, epochs=5, antithetic=True,
            stratified=True, device="cpu", graph=graph)

    eager = mc(False)
    got = mc(True)
    for k in eager.history:
        np.testing.assert_array_equal(got.history[k], eager.history[k])
    assert_trees_equal(got.params, eager.params)
    assert_trees_equal(got.ema_params, eager.ema_params)
    assert [g.replays for g in stub_captures] == [4]
    vb = tvar.dual_grid_vbatch(cfg, 2, 8, 6, device="cpu")
    logs = {True: [], False: []}
    out = {g: tvar._adam_minimize(params, cfg, vb, 8, 1.0, graph=g,
                                  log_cb=lambda i, m, g=g: logs[g].append(
                                      (i, m)))
           for g in (False, True)}
    assert_trees_equal(tans.to_numpy_params(out[True]),
                       tans.to_numpy_params(out[False]))
    assert logs[True] == logs[False] and logs[True][0][0] == 8
    assert [g.replays for g in stub_captures] == [4, 7]


# ---------------------------------------------------------------------------
# the routes' head evaluations a step


class CapturingStub(graphs.StepGraph):
    """StepGraph whose capture runs ``fn`` once, as recording a graph runs
    the step's Python, and whose replays run nothing: what a replay adds
    to the counts is StepGraph's own bookkeeping."""

    def eager(self):
        self.fn()

    def record(self):
        self.fn()
        return StubGraph()


def _head_eval_steps(trainer):
    """(a step of the trainer, the head evaluations one step makes): the
    quotient's steps evaluate the R-only heads once an R row, the
    residual's once a point."""
    if trainer == "residual":
        cfg = train_cfg(resample_every=1, resample_frac=1.0)
        gen = torch.Generator().manual_seed(0)
        tr = teng.Trainer(cfg, device="cpu", generator=gen)

        def sample(g):
            return tsam.sample_batch(g, cfg, device="cpu")

        tr.batch = sample(gen)
        return (lambda: tr.advance(sample)), {"rows": 0,
                                              "points": tr.batch.x.numel()}
    cfg = train_cfg("separable")
    params = tans.init_params(cfg.model, seed=1, dtype="float64",
                              device="cpu")
    if trainer == "monte_carlo":
        mc = tvar.MonteCarloTrainer(cfg, params, 2, 64,
                                    torch.Generator().manual_seed(3),
                                    device="cpu")
        return mc.advance, {"rows": 2, "points": 0}
    vb = tvar.dual_grid_vbatch(cfg, 2, 8, 6, device="cpu")
    warm = tvar.AdamWarmup(params, cfg, vb, 5, 1.0)
    return warm.advance, {"rows": vb.r.numel(), "points": 0}


@pytest.mark.parametrize("captured", [False, True])
@pytest.mark.parametrize("trainer", ["monte_carlo", "adam_warmup",
                                     "residual"])
def test_head_evals_a_step(trainer, captured, monkeypatch):
    """One Monte-Carlo or Adam-warmup step adds its R rows to
    ``routing.head_evals["rows"]`` and nothing to ``"points"``; one
    residual step adds its batch's points to ``"points"``. A captured
    step's replays add what its eager steps add (``routing.COUNTERS``)."""
    assert any(c is routing.head_evals for c in routing.COUNTERS)
    if captured:
        monkeypatch.setattr(graphs, "StepGraph", CapturingStub)
        monkeypatch.setattr(graphs, "captures",
                            lambda device, mesh=None, graph=True:
                            bool(graph) and mesh is None)
    step, want = _head_eval_steps(trainer)
    for _ in range(4):       # eager, capture + replay, then replays
        before = dict(routing.head_evals)
        step()
        assert {k: routing.head_evals[k] - before[k]
                for k in before} == want


# ---------------------------------------------------------------------------
# the capturable Adam against optax


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_adam_equals_optax_on_the_same_gradients(dtype):
    """12 steps of engine.Adam under the staircase schedule (the rate set
    from optax's own schedule on its int32 count) against optax.adam on
    the same gradients, spread over ten decades so that eps matters:
    params and moments within 4 units in the last place."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=64).astype(dtype)
    grads = [(rng.normal(size=64) * 10.0 ** rng.integers(-9, 1, size=64))
             .astype(dtype) for _ in range(12)]
    sched = optax.exponential_decay(3e-3, 3, 0.5, staircase=True)
    with jax.enable_x64(dtype == "float64"):
        opt = optax.adam(sched)
        pj = jnp.asarray(p0)
        st = opt.init(pj)
        for g in grads:
            u, st = opt.update(jnp.asarray(g), st, pj)
            pj = optax.apply_updates(pj, u)
        lrs = [float(sched(jnp.int32(i))) for i in range(12)]
    pt = torch.tensor(p0)
    adam = teng.Adam(pt, lr=3e-3)
    for lr, g in zip(lrs, grads):
        adam.set_lr(lr)
        adam.step(torch.tensor(g))
    rtol = 4 * np.finfo(dtype).eps
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=rtol)
    np.testing.assert_allclose(adam.mu.numpy(), np.asarray(st[0].mu),
                               rtol=rtol)
    np.testing.assert_allclose(adam.nu.numpy(), np.asarray(st[0].nu),
                               rtol=rtol)
    assert int(adam.count) == int(st[0].count) == 12
