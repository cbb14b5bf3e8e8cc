"""The harness: a cell resolved by name, one run of it, its result line.

Everything that belongs to one cell is a file found by name:
``BENCHMARK.json``'s workload entry names the configuration
(``configs/<config>.json``) and the traffic (``traffic/<traffic>.json``),
the traffic file names its kind (``mixes/<kind>.py``), the cell's limits
are ``limits/<cell>.json``, and each per-layer metric the cell reports is
``metrics/<metric>.py``.

A run (``run``):

1. builds or loads K1 and K2 (the program's ``ops/_build.py``);
2. makes the weights on the device from the seed (``weights.make``);
3. builds the cell's entry object, which draws or builds its batch;
4. takes the first ``RECORD_STEPS`` steps through it, keeping what the
   comparison reads (the program captures its step graph there);
5. takes one more chunk of ``read_every`` steps;
6. drives the entry for ``seconds`` in whole chunks, the host reading the
   device once a chunk as the program's loop does, and nothing more;
7. with ``trace``, times the host's issue of each step of one more chunk
   with the device's queue drained before it (``issue_spans``), then
   profiles one more chunk (``trace.run``);
8. frees the program, then runs the reference (``reference``) over the
   same first steps and compares (``check``).
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax",
             "pinn_for_quantum_wavefunction_surfaces_tpu")
RECORD_STEPS = 3
TOP = 10


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root=None) -> dict:
    return load_json(Path(root or HERE.parent) / "BENCHMARK.json")


def resolve(name: str, bench: dict) -> SimpleNamespace:
    """The cell ``name`` of ``bench`` with its files: configuration,
    traffic, kind, limits (None where the cell has none yet), and the
    end-to-end and per-layer metrics it reports."""
    from . import metrics, mixes
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = HERE / "limits" / f"{name}.json"

    def applies(m, default):
        return name in m["workloads"] if "workloads" in m else default

    e2e = [m for m in bench["end_to_end"] if applies(m, True)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m, m["moves"] in moved)]
    return SimpleNamespace(
        name=name, workload=w,
        config=load_json(HERE / "configs" / f"{w['config']}.json"),
        traffic=traffic, kind=mixes.load(traffic["kind"]),
        limits=load_json(limits)["limits"] if limits.exists() else None,
        end_to_end=e2e,
        per_layer={m["name"]: metrics.load(m["name"]) for m in per_layer},
        units={m["name"]: m["unit"] for m in e2e + per_layer})


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark's process may
    not hold, compared whole (the program's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def issue_spans(mix) -> list[float]:
    """Host seconds of each ``advance`` of one chunk, each begun with the
    device's queue drained: the trainer loop's own cost of issuing a step,
    which a full queue would otherwise hide behind its wait."""
    import torch
    spans = []
    for _ in range(mix.read_every):
        torch.cuda.synchronize()
        a = time.perf_counter()
        mix.step()
        spans.append(time.perf_counter() - a)
    mix.read()
    return spans


def program_record(cell, seed: int, device, base=None):
    """(mix, record, params): the cell's entry built from the seed's
    weights (``weights.make``, from the draw of ``base``), after its first
    ``RECORD_STEPS`` steps."""
    import torch

    from . import program, weights
    dtype = getattr(torch, cell.traffic["dtype"])
    if torch.device(device).type == "cuda":
        program.build_kernels()
    params = weights.make(cell.config["model"], seed, dtype, device, base)
    start = {k: {f: t.detach().clone() for f, t in v.items()}
             for k, v in params.items()}
    mix = cell.kind.build(cell.config, cell.traffic, params, seed, device)
    rec = mix.record(start, RECORD_STEPS)
    mix.read()          # ends the partial chunk of the recorded steps
    return mix, rec, start


def reference_record(cell, seed: int, params, device, dtype=None,
                     keep: float = 1.0, use_tf32: bool = False) -> dict:
    """The reference's record of the same first steps, in ``dtype``
    (float64 by default)."""
    import torch
    return cell.kind.reference(cell.config, cell.traffic, params, seed,
                               device, dtype or torch.float64,
                               RECORD_STEPS, keep, use_tf32)


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        started=None, log=print) -> tuple[dict, dict]:
    """One run of ``cell``: (result line, {number: {value, limit}})."""
    import torch

    from . import check, program, yardstick
    from . import trace as tracing
    started = time.perf_counter() if started is None else started
    cuda = torch.device(device).type == "cuda"
    if cell.limits is None:
        raise RuntimeError(f"{cell.name} has no limits file: set its limits "
                           "from readings first (portbench.calibrate)")
    mix, rec, start = program_record(cell, seed, device)
    clock = time.perf_counter
    for _ in range(mix.read_every):
        mix.step()
    mix.read()
    setup_s = started() if callable(started) else \
        time.perf_counter() - started
    launches0 = program.launches()
    steps = failed = 0
    chunks = []
    t0 = clock()
    while True:
        c0 = clock()
        for _ in range(mix.read_every):
            mix.step()
        loss = mix.read()
        chunks.append(clock() - c0)
        steps += mix.read_every
        if not math.isfinite(loss):
            failed += mix.read_every
        if clock() - t0 >= seconds:
            break
    window_s = clock() - t0
    launches = program.launches() - launches0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    profile, spans = None, []
    if trace and cuda:
        spans = issue_spans(mix)
        profile = tracing.run(mix, mix.read_every,
                              os.environ.get("TMPDIR", "/tmp"))
    notes, points, kernel_points = mix.notes(), mix.points, mix.kernel_points
    step_flops = yardstick.step_flops(cell.config["model"],
                                      cell.kind.OBJECTIVE, points, mix.rows)
    del mix
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_record(cell, seed, start, device)
    readings = check.gaps(rec, ref)
    ok, checks = check.decide(readings, cell.limits)
    result = {"correct": bool(ok), "attempted": steps, "failed": failed}
    ctx = SimpleNamespace(
        model=cell.config["model"], dtype=cell.traffic["dtype"],
        steps=steps, window_s=window_s, spans=spans, launches=launches,
        profile=profile, points=points, kernel_points=kernel_points,
        step_flops=step_flops)
    if trace:
        values = {}
        for name, reader in cell.per_layer.items():
            if profile is None and name in PROFILED:
                continue
            v = reader.read(ctx)
            if v is not None:
                values[name] = v
        result["metrics"] = {k: {"value": v, "unit": cell.units[k]}
                             for k, v in values.items()}
    else:
        result["metrics"] = {
            "points_per_s": {"value": steps * points / window_s,
                             "unit": "points/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        result["device"]["power_limit"] = power_limit()
    if profile is not None:
        result["device"]["busy_s"] = profile["busy_s"]
        result["device"]["window_s"] = profile["window_s"]
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in profile["ops"][:TOP]],
            "idle_gaps": [[n, s] for n, s in profile["gaps"][:TOP]]}
    log(json.dumps({"portbench": cell.name, "seed": seed, "steps": steps,
                    "window_s": window_s, "setup_s": setup_s,
                    "points_per_step": points,
                    "kernel_points_per_step": kernel_points,
                    "model_flops_per_step": step_flops,
                    "memory_peak_bytes": int(peak), "notes": notes,
                    "chunk_s": chunks,
                    "record": rec, "reference": ref}), file=sys.stderr)
    result["checks"] = checks
    return result, checks


# the metrics that read the profiled stretch
PROFILED = ("torch_ops_ms_per_step", "k1_roofline", "k2_roofline",
            "device_idle_share")

