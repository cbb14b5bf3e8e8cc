"""The traced stretch: ``torch.profiler`` over a short steady run of steps
after the window, and what the readers take from its device trace.

The harness marks its own spans on the host (``portbench.advance`` around
each step, ``portbench.read`` around each read of the device, and
``portbench.stretch`` around the whole stretch, which ends in a
synchronise); the trace's device rows (kernels, copies, sets) give each
kernel's time, the union of busy intervals, and the idle gaps, each gap
labelled with the harness span the host was in when it began.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict

import torch

from . import program

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "portbench."


def run(mix, steps: int, tmpdir: str) -> dict:
    """Profile ``steps`` steps of ``mix`` (its reads included); returns
    ``parse`` of the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN + "stretch"):
            for j in range(steps):
                with record_function(SPAN + "advance"):
                    mix.step()
                if (j + 1) % mix.read_every == 0:
                    with record_function(SPAN + "read"):
                        mix.read()
            torch.cuda.synchronize()
    path = os.path.join(tmpdir, "portbench_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    out = parse(events)
    out["steps"] = steps
    return out


def parse(events) -> dict:
    """{"window_s", "busy_s", "group_s": {K1, K2, K3, torch: seconds},
    "ops": [(name, seconds)] by total time, "gaps": [(span, seconds)]
    longest first} of the trace's ``portbench.stretch``."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN)]
    stretch = [e for e in spans if e["name"] == SPAN + "stretch"]
    if not stretch:
        raise RuntimeError("the trace has no portbench.stretch span")
    t0 = float(stretch[0]["ts"])
    t1 = t0 + float(stretch[0]["dur"])
    dev = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        a, b = max(a, t0), min(b, t1)
        if b > a:
            dev.append((a, b, str(e.get("name", ""))))
    dev.sort()
    group = defaultdict(float)
    ops = defaultdict(float)
    for a, b, name in dev:
        group[program.kernel_of(name) or "torch"] += (b - a) * 1e-6
        ops[name] += (b - a) * 1e-6
    # the union of the device's busy intervals and the gaps between them
    busy, gaps, end = 0.0, [], t0
    for a, b, _ in dev:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if t1 > end:
        gaps.append((end, t1))
    inner = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"][len(SPAN):]) for e in spans
                   if e["name"] != SPAN + "stretch")
    starts = [s[0] for s in inner]

    def label(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and inner[i][1] >= t:
            return inner[i][2]
        return "between spans"

    gaps = sorted(((label(a), (b - a) * 1e-6) for a, b in gaps),
                  key=lambda g: -g[1])
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": busy * 1e-6,
            "group_s": dict(group),
            "ops": sorted(ops.items(), key=lambda o: -o[1]),
            "gaps": gaps}
