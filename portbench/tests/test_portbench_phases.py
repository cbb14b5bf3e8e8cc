"""The program-trace stage (``portbench/phases.py``): the idle-gap
attribution on a hand-written trace, the readers of the phase metrics and
of ``launch_wait_share`` on a synthetic ``ctx`` (the cases that find
nothing included), the cells that report them, and the stage itself on
the CPU at smoke size."""

from types import SimpleNamespace

import pytest

from portbench import harness, metrics, phases
from portbench.tests import smoke

NEW = ("sample_ms_per_step", "forward_ms_per_step", "backward_ms_per_step",
       "update_ms_per_step", "launch_wait_share")
PHASE_METRICS = NEW[:4]


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    ev("user_annotation", "portbench.stretch", 0.0, 1000.0),
    ev("user_annotation", "portbench.advance", 0.0, 300.0),
    ev("user_annotation", "pinn.advance", 2.0, 288.0),
    ev("user_annotation", "pinn.step", 4.0, 36.0),
    ev("user_annotation", "pinn.resample", 190.0, 70.0),
    ev("user_annotation", "portbench.read", 600.0, 400.0),
    # graph launch 1 (in pinn.step): two kernels, a gap inside the graph;
    # the gap before its first kernel is the profiler's start
    ev("cuda_runtime", "cudaGraphLaunch", 5.0, 10.0, corr=1),
    ev("kernel", "k_a", 50.0, 50.0, corr=1),
    ev("kernel", "k_b", 120.0, 30.0, corr=1),
    # launch 2 begins (in pinn.resample) after the device went idle
    ev("cuda_runtime", "cudaGraphLaunch", 200.0, 10.0, corr=2),
    ev("kernel", "k_c", 230.0, 30.0, corr=2),
    # launch 3 began before the gap: launch latency
    ev("cuda_runtime", "cudaLaunchKernel", 240.0, 5.0, corr=3),
    ev("kernel", "k_d", 300.0, 50.0, corr=3),
    # the read's copy, launched in portbench.read after the gap began
    ev("cuda_runtime", "cudaMemcpyAsync", 700.0, 5.0, corr=4),
    ev("gpu_memcpy", "Memcpy DtoH", 720.0, 10.0, corr=4),
    # launch 6, in portbench.read after the gap before it began; the gap
    # between its two ops is inside it, though the trace times its call
    # after that gap began too
    ev("cuda_runtime", "cudaGraphLaunch", 775.0, 5.0, corr=6),
    ev("kernel", "k_e", 760.0, 10.0, corr=6),
    ev("kernel", "k_f", 780.0, 10.0, corr=6),
    # outside the stretch
    ev("kernel", "outside", 2000.0, 10.0, corr=5),
]


def test_attribute_labels_each_gap():
    a = phases.attribute(EVENTS)
    assert a["span_s"] == pytest.approx(950e-6)
    assert [w[0] for w in a["waits"]] == ["portbench.read", "pinn.resample",
                                          "portbench.read"]
    assert [w[1] for w in a["waits"]] == pytest.approx([370e-6, 80e-6,
                                                         30e-6])
    # [100, 120] in launch 1, [770, 780] in launch 6
    assert a["in_graph_s"] == pytest.approx(30e-6)
    assert a["latency_s"] == pytest.approx(40e-6)
    # neither the leading gap (50 us) nor the trailing one (210 us) is
    # attributed; the ops are busy 190 us
    assert sum(w[1] for w in a["waits"]) + a["in_graph_s"] + \
        a["latency_s"] == pytest.approx((1000 - 50 - 190 - 210) * 1e-6)


def test_attribute_without_device_ops_or_stretch():
    a = phases.attribute(EVENTS[:6])
    assert a == {"span_s": 0.0, "waits": [], "in_graph_s": 0.0,
                 "latency_s": 0.0}
    with pytest.raises(RuntimeError, match="stretch"):
        phases.attribute(EVENTS[1:])


def ctx(profile=True):
    return SimpleNamespace(profile={"steps": 100} if profile else None)


STAGE = {"phases": {"sample": 0.4, "forward": 0.7, "backward": 1.1,
                    "update": 0.2},
         "waits": {"span_s": 0.5, "waits": [("pinn.step", 0.01),
                                            ("portbench.read", 0.005)],
                   "in_graph_s": 0.002, "latency_s": 0.001},
         "stage_s": 3.0}


def read_all(c):
    return {n: metrics.load(n).read(c) for n in NEW}


def test_readers(monkeypatch):
    monkeypatch.setattr(phases, "stage", lambda c: STAGE)
    got = read_all(ctx())
    assert got == {"sample_ms_per_step": 0.4, "forward_ms_per_step": 0.7,
                   "backward_ms_per_step": 1.1, "update_ms_per_step": 0.2,
                   "launch_wait_share": pytest.approx(3.0)}


def test_readers_that_find_nothing_return_nothing(monkeypatch):
    # no profiled stretch (a run without CUDA): the stage is not run
    monkeypatch.setattr(phases, "run", lambda *a, **k: pytest.fail("ran"))
    assert set(read_all(ctx(profile=False)).values()) == {None}
    # no cell on the command line
    monkeypatch.setattr(phases.sys, "argv", ["probe"])
    assert set(read_all(ctx()).values()) == {None}
    # a program without tracing: no phases, the launch waits still read
    parent = {**STAGE, "phases": None}
    monkeypatch.setattr(phases, "stage", lambda c: parent)
    got = read_all(ctx())
    assert [got[n] for n in PHASE_METRICS] == [None] * 4
    assert got["launch_wait_share"] == pytest.approx(3.0)
    # a trainer without a sample phase (the polish), a run without CUDA
    polish = {**STAGE, "phases": {"forward": 0.5, "backward": 0.3,
                                  "update": 0.1}, "waits": None}
    monkeypatch.setattr(phases, "stage", lambda c: polish)
    got = read_all(ctx())
    assert got["sample_ms_per_step"] is None
    assert got["forward_ms_per_step"] == 0.5
    assert got["launch_wait_share"] is None


def test_the_stage_runs_once_a_process(monkeypatch):
    runs = []
    monkeypatch.setattr(phases, "_done", {})
    monkeypatch.setattr(phases.sys, "argv", [
        "run.py", "--workload", "flagship-separable.mc", "--seed",
        "4294967311", "--seconds", "51", "--trace", "1"])
    monkeypatch.setattr(phases, "run", lambda cell, seed, **k:
                        runs.append((cell.name, seed)) or STAGE)
    for _ in range(3):
        assert read_all(ctx())["forward_ms_per_step"] == 0.7
    assert runs == [("flagship-separable.mc", 4294967311)]


@pytest.mark.parametrize("name,sample", [
    ("flagship-separable.polish-adam", False),
    ("flagship-separable.mc", True), ("paper-symmetric-gz.train", True)])
def test_each_cell_reports_the_program_trace_metrics(name, sample):
    cell = harness.resolve(name, harness.benchmark())
    want = set(NEW) - (set() if sample else {"sample_ms_per_step"})
    assert set(cell.per_layer) & set(NEW) == want
    for n in want:
        assert callable(cell.per_layer[n].read)


@pytest.mark.parametrize("name,want", [
    ("flagship-separable.polish-adam", {"forward", "backward", "update"}),
    ("flagship-separable.mc", {"sample", "forward", "backward", "update"}),
    ("paper-symmetric-gz.train",
     {"sample", "forward", "backward", "update"})])
def test_the_stage_on_the_cpu(name, want):
    """At smoke size on the CPU (the steps eager, the host clock): every
    phase of the cell's trainer, each with a non-negative time; no
    profiled chunk without CUDA."""
    lines = []
    out = phases.run(smoke.cell(name), 7, "cpu",
                     log=lambda *a, **k: lines.append(a[0]))
    assert set(out["phases"]) == want
    assert min(out["phases"].values()) >= 0.0
    assert out["waits"] is None and out["stage_s"] > 0
    assert len(lines) == 1 and name in lines[0]
    from portbench import program
    assert not program.module("utils.profiling").enabled()
