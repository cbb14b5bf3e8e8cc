"""The port's tracing (utils/profiling.py) on the CPU: the switch, the
``pinn.*`` spans in a torch.profiler trace, the trainers' phase marks, the
recapture of a step graph when tracing is switched, and that tracing
changes no step.

- Off (the default): a span is the shared no-op, a mark records nothing,
  the trainers' ``phases()`` are empty and a profiler sees no ``pinn.*``
  span.
- On: the trace holds ``pinn.advance``, ``pinn.resample``, ``pinn.step``,
  ``pinn.capture`` and ``pinn.read``; each trainer's ``phases()`` names its
  phases, each with a non-negative time (the host clock on the CPU), and
  ``engine.train``'s log records carry them.
- A ``StepGraph`` captures again exactly once when the tracing state
  differs from its graph's.
- ``engine.Trainer``, ``MonteCarloTrainer`` and ``AdamWarmup`` take the
  same 5 steps, bit for bit, with tracing on, off, and switched on midway
  (with stub graphs that replay the recorded step).

torch runs on one thread (see test_torch_excited.py)."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    sampling as tsam
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    engine as teng
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    graphs
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    variational as tvar
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.utils import profiling

from test_torch_excited import one_torch_thread  # noqa: F401
from test_torch_graphs import CpuStepGraph, StubGraph, train_cfg
from test_torch_separable import no_jax_cache_writes  # noqa: F401

STEPS = 5
PHASES = {"trainer": {"sample", "forward", "backward", "update"},
          "monte_carlo": {"sample", "forward", "backward", "update"},
          "warmup": {"forward", "backward", "update"}}


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off."""
    profiling.enable(False)
    yield
    profiling.enable(False)


def make(kind):
    """A fresh trainer of ``kind`` on the CPU and its one-step callable."""
    if kind == "trainer":
        cfg = train_cfg(resample_every=1, resample_frac=1.0, epochs=20)
        gen = torch.Generator().manual_seed(0)
        tr = teng.Trainer(cfg, device="cpu", generator=gen)

        def sample(g):
            return tsam.sample_batch(g, cfg, device="cpu")

        tr.batch = sample(gen)
        return tr, lambda: tr.advance(sample)
    cfg = train_cfg("separable", lr_schedule="none")
    params = tans.init_params(cfg.model, seed=1, dtype="float64",
                              device="cpu")
    if kind == "monte_carlo":
        mc = tvar.MonteCarloTrainer(cfg, params, 2, 64,
                                    torch.Generator().manual_seed(3),
                                    antithetic=True, stratified=True,
                                    device="cpu")
        return mc, mc.advance
    vb = tvar.dual_grid_vbatch(cfg, 2, 8, 6, device="cpu")
    warm = tvar.AdamWarmup(params, cfg, vb, 8, 1.0)
    return warm, warm.advance


def state(kind, tr):
    """What a step leaves: the trained vector and the step's loss row."""
    if kind == "warmup":
        return [tr.flat.detach().clone(), tr.loss.detach().clone()]
    out = [tr.flat.detach().clone(), tr.row.clone(), tr.opt.mu.clone()]
    if kind == "trainer":
        out += [tr.best_flat.clone(), tr.ema_flat.clone()]
    return out


def pinn_spans(prof) -> list[str]:
    return [e.name for e in prof.events()
            if e.name.startswith(profiling.SPAN)]


@pytest.mark.parametrize("kind", sorted(PHASES))
def test_tracing_off_records_nothing(kind):
    assert not profiling.enabled()
    assert profiling.annotate("advance", 3) is profiling.annotate("step")
    with profiling.recording() as marks:
        profiling.mark("forward")
    assert marks is None
    tr, step = make(kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step()
    assert pinn_spans(prof) == []
    assert tr.phases() == {}


@pytest.mark.parametrize("kind", sorted(PHASES))
def test_tracing_on_names_each_phase(kind):
    tr, step = make(kind)
    step()
    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    ph = tr.phases()
    assert set(ph) == PHASES[kind]
    assert all(v >= 0.0 for v in ph.values()), ph
    spans = set(pinn_spans(prof))
    want = {"pinn.advance", "pinn.step"}
    if kind == "trainer":
        want.add("pinn.resample")
    assert spans == want


def test_marks_time_each_phase_to_the_next():
    profiling.enable(True)
    with profiling.recording() as marks:
        profiling.mark("a")
        profiling.mark("b")
        profiling.mark("a")
    assert [m[0] for m in marks] == ["a", "b", "a", None]
    ph = profiling.phase_ms(marks)
    assert set(ph) == {"a", "b"}
    t = [m[1] for m in marks]
    assert ph["a"] == pytest.approx(1e3 * (t[1] - t[0] + t[3] - t[2]))
    assert profiling.phase_ms(None) == {} and profiling.phase_ms([]) == {}


def test_trace_turns_tracing_on_for_its_region(tmp_path):
    with profiling.trace(str(tmp_path)):
        assert profiling.enabled()
        with profiling.annotate("probe", 7):
            torch.ones(3).mul_(2.0)
    assert not profiling.enabled()
    with open(tmp_path / profiling.TRACE_NAME) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "pinn.probe" in names


class Counted(graphs.StepGraph):
    """StepGraph with stub graphs that counts its captures."""

    def __init__(self, fn):
        super().__init__(fn, capture=True, counters=())
        self.captured = 0

    def eager(self):
        self._run()

    def record(self):
        self.captured += 1
        self._run()          # a capture records the step's marks
        return StubGraph()


def test_step_graph_captures_again_once_when_tracing_is_switched():
    runs = []

    def fn():
        profiling.mark("work")
        runs.append(1)

    step = Counted(fn)
    for _ in range(3):
        step()
    assert step.captured == 1 and not step.traced and step.phases() == {}
    first = step.graph
    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            step()
    assert pinn_spans(prof) == ["pinn.capture"]
    assert step.captured == 2 and step.traced and step.graph is not first
    assert set(step.phases()) == {"work"}
    profiling.enable(False)
    for _ in range(2):
        step()
    assert step.captured == 3 and not step.traced and step.phases() == {}
    # one eager call and three captures ran fn; the rest replayed
    assert len(runs) == 4


@pytest.mark.parametrize("kind", sorted(PHASES))
def test_tracing_changes_no_step(kind, monkeypatch):
    """5 steps eager with tracing off, on, and (stub graphs) switched on
    after the second step: the same losses and parameters, bit for bit."""
    def run(on, switch_at=None):
        profiling.enable(on)
        tr, step = make(kind)
        rows = []
        for i in range(STEPS):
            if i == switch_at:
                profiling.enable(True)
            step()
            rows.append(state(kind, tr))
        profiling.enable(False)
        return rows

    off = run(False)
    on = run(True)
    monkeypatch.setattr(graphs, "StepGraph", CpuStepGraph)
    monkeypatch.setattr(graphs, "captures",
                        lambda device, mesh=None, graph=True:
                        bool(graph) and mesh is None)
    switched = run(False, switch_at=2)
    for a, b, c in zip(off, on, switched):
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y) and torch.equal(x, z)


def test_train_logs_the_phase_ms_while_tracing_is_on():
    cfg = train_cfg(epochs=6, scan_chunk=3)
    logs = {}
    for on in (False, True):
        profiling.enable(on)
        got = []
        teng.train(cfg, device="cpu",
                   log_cb=lambda i, m, got=got: got.append(m))
        logs[on] = got
    assert len(logs[True]) == len(logs[False]) == 2
    assert not any(k.endswith("_ms") for m in logs[False] for k in m)
    # the chunks end at steps 2 and 5; step 2 resamples (every 2 steps
    # while the step is under int(0.6 * 6) = 3), step 5 does not
    wants = ({"sample_ms", "forward_ms", "backward_ms", "update_ms"},
             {"forward_ms", "backward_ms", "update_ms"})
    for off, on, want in zip(logs[False], logs[True], wants):
        extra = {k: v for k, v in on.items() if k not in off}
        assert set(extra) == want
        assert all(v >= 0.0 for v in extra.values())
        assert {k: on[k] for k in off} == off


def test_the_loops_read_the_device_in_a_span():
    cfg = train_cfg("separable", scan_chunk=2, lr_schedule="none")
    params = tans.init_params(cfg.model, seed=1, dtype="float64",
                              device="cpu")
    vb = tvar.dual_grid_vbatch(cfg, 2, 8, 6, device="cpu")
    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        teng.train(train_cfg(epochs=2, scan_chunk=2), device="cpu")
        tvar.train_variational(cfg, params, n_r=2, n_pts=64, epochs=2,
                               device="cpu")
        tvar._adam_minimize(params, cfg, vb, 100, 1.0,
                            log_cb=lambda *a: None)
    spans = pinn_spans(prof)
    assert spans.count("pinn.read") == 3
    assert spans.count("pinn.advance") == 2 + 2 + 100

