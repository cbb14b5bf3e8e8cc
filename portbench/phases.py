"""The program's own tracing, read in a traced run: the phases of its
captured step and the launch waits of the device.

The harness calls a traced run's per-layer readers after the window, the
profiled stretch (``trace.py``, the program's tracing off) and the
reference. The readers of the phase metrics and of ``launch_wait_share``
share one more stage (``stage``), run once a process on a fresh entry of
the run's own cell and seed (``--workload`` and ``--seed`` of its command
line):

1. the entry built and taken through its first steps as in set-up
   (``harness.program_record``: eager, capture, replay; tracing off);
2. the program's tracing on (``utils/profiling.enable``) and one untimed
   chunk, in which its step graphs are captured again with their marks;
3. the phase chunk: each step followed by a synchronise and its trainer's
   ``phases()``; a phase's ms a step is its mean over the chunk's steps (a
   step without the phase counts 0);
4. one more chunk profiled as ``trace.run`` profiles one, the program's
   spans on, and its idle gaps attributed (``attribute``).

Then tracing is off again and the entry freed. A program older than its
tracing has no switch: it gives no phases, and its chunk is still profiled,
the gaps labelled by the harness's spans alone. The stage prints its
numbers as one JSON line on standard error, the ten longest launch waits
among them.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import os
import sys
import tempfile
import time

from . import trace

PROGRAM = "pinn."
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10

_done: dict = {}


def attribute(events) -> dict:
    """The idle gaps of the trace's ``portbench.stretch``: {"span_s": the
    time from its first device op to its end, "waits": [(label, seconds)]
    longest first, "in_graph_s", "latency_s"}.

    A gap between the device's busy intervals lies inside one launch (a
    graph's) when the ops on both sides share its correlation id (``in
    graph``): the launch was made before the first of them ran. Else it is
    a launch wait when the device op that ends it was launched by a
    runtime call (matched by the trace's ``correlation`` id) that began
    after the gap began: the device waited for the host. A wait is
    labelled with the innermost span around that call, a program span
    (``pinn.*``) first, else a harness span (``portbench.*``). Every other
    gap is launch latency. The gap before the stretch's first device op is
    the profiler's start, and the one after its last op the stretch's
    closing synchronise: both are left out."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith((PROGRAM, trace.SPAN))]
    stretch = [e for e in spans if e["name"] == trace.SPAN + "stretch"]
    if not stretch:
        raise RuntimeError("the trace has no portbench.stretch span")
    t0 = float(stretch[0]["ts"])
    t1 = t0 + float(stretch[0]["dur"])
    launched = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = float(e["ts"])
    dev = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        a, b = max(a, t0), min(b, t1)
        if b > a:
            dev.append((a, b, (e.get("args") or {}).get("correlation")))
    dev.sort(key=lambda d: d[:2])
    out = {"span_s": 0.0, "waits": [], "in_graph_s": 0.0, "latency_s": 0.0}
    if not dev:
        return out
    by_kind = {}
    for prefix in (PROGRAM, trace.SPAN):
        inner = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e["name"]) for e in spans
                       if e["name"].startswith(prefix))
        by_kind[prefix] = (inner, [s[0] for s in inner])

    def label(t):
        for inner, starts in by_kind.values():
            # the innermost span around t: the latest begun that holds it
            for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
                if inner[i][1] >= t:
                    return inner[i][2]
        return "between spans"

    end, before = dev[0][1], dev[0][2]
    for a, b, corr in dev[1:]:
        if a > end:
            gap = (a - end) * 1e-6
            call = launched.get(corr)
            if corr is not None and corr == before:
                out["in_graph_s"] += gap
            elif call is not None and call > end:
                out["waits"].append((label(call), gap))
            else:
                out["latency_s"] += gap
        if b > end:
            end, before = b, corr
    out["waits"].sort(key=lambda w: -w[1])
    out["span_s"] = (t1 - dev[0][0]) * 1e-6
    return out


def trainer_of(mix):
    """The program's trainer that a mix drives: the first of its
    attributes with a ``phases`` method, or None."""
    for v in vars(mix).values():
        if callable(getattr(v, "phases", None)):
            return v
    return None


def phase_chunk(mix, trainer, cuda: bool) -> dict:
    """{phase: mean device ms a step} over one chunk of ``mix``, each step
    followed by a synchronise and the trainer's ``phases()``."""
    import torch
    sums, n = {}, mix.read_every
    for _ in range(n):
        mix.step()
        if cuda:
            torch.cuda.synchronize()
        for k, v in trainer.phases().items():
            sums[k] = sums.get(k, 0.0) + v
    mix.read()
    return {k: v / n for k, v in sums.items()}


def profiled_events(mix) -> list:
    """The trace events of one chunk of ``mix`` profiled as ``trace.run``
    profiles one."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.SPAN + "stretch"):
            for _ in range(mix.read_every):
                with record_function(trace.SPAN + "advance"):
                    mix.step()
            with record_function(trace.SPAN + "read"):
                mix.read()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "program_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def run(cell, seed: int, device="cuda", log=print) -> dict:
    """The stage on ``cell`` and ``seed``: {"phases": {phase: ms a step}
    or None (a program without tracing), "waits": ``attribute`` of the
    profiled chunk, or None without CUDA, "stage_s"}."""
    import torch

    from . import harness, program
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    mix, _, _ = harness.program_record(cell, seed, device)
    switch = getattr(program.module("utils.profiling"), "enable", None)
    trainer = trainer_of(mix)
    out = {"phases": None, "waits": None}
    try:
        if switch is not None:
            switch(True)
        for _ in range(mix.read_every):
            mix.step()
        mix.read()
        if switch is not None and trainer is not None:
            out["phases"] = phase_chunk(mix, trainer, cuda)
        if cuda:
            out["waits"] = attribute(profiled_events(mix))
    finally:
        if switch is not None:
            switch(False)
    del mix, trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["stage_s"] = time.perf_counter() - t0
    waits = out["waits"]
    log(json.dumps({"portbench_program_trace": cell.name,
                    "phases_ms": out["phases"], "stage_s": out["stage_s"],
                    "launch_waits": waits and waits["waits"][:TOP],
                    "in_graph_s": waits and waits["in_graph_s"],
                    "latency_s": waits and waits["latency_s"],
                    "span_s": waits and waits["span_s"]}), file=sys.stderr)
    return out


def command_cell():
    """(workload, seed) of this process's command line, or None."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    args, _ = p.parse_known_args(sys.argv[1:])
    if args.workload is None or args.seed is None:
        return None
    return args.workload, args.seed


def stage(ctx):
    """The stage's result for this process's run, run at the first call;
    None where a reader finds nothing to read: no profiled stretch (a run
    without CUDA), or no cell on the command line."""
    if ctx.profile is None:
        return None
    key = command_cell()
    if key is None:
        return None
    if key not in _done:
        from . import harness
        _done[key] = run(harness.resolve(key[0], harness.benchmark()),
                         key[1])
    return _done[key]


def phase_ms_per_step(ctx, name: str):
    """The stage's device ms a step of phase ``name``, or None."""
    st = stage(ctx)
    if st is None or not st["phases"] or name not in st["phases"]:
        return None
    return st["phases"][name]


def launch_wait_share(ctx):
    """% of the profiled chunk's time, from its first device op, that the
    device spent in launch waits; None without a profiled chunk."""
    st = stage(ctx)
    if st is None or not st["waits"] or st["waits"]["span_s"] <= 0:
        return None
    w = st["waits"]
    return 100.0 * sum(s for _, s in w["waits"]) / w["span_s"]
