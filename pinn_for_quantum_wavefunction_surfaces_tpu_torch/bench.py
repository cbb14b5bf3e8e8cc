"""The bench line: collocation-point throughput of the training step.

The PyTorch counterpart of the root ``bench.py`` (which the JAX package's
``cli bench`` runs). Prints ONE JSON line with that script's keys:

    {"metric": "collocation_points_per_sec", "value": N, "unit": "points/s",
     "vs_baseline": R, ..., "separable": {...}}

- ``measure_ours``: ``engine.Trainer`` steps (resampling a fresh batch
  each step, Adam) at ``n`` points, one warm-up chunk of ``steps`` steps,
  then the best of ``repeats`` timed chunks, each ended by
  ``torch.cuda.synchronize()``. On the card the symmetric family trains
  through K2 (``csrc/train_{fwd,bwd}.cu``), the separable family through
  K1 (``csrc/separable_{fwd,bwd}.cu``); ``kernel`` says "cuda", or "plain"
  under ``--device cpu``. With no ``--arch`` both families are measured,
  the separable one under the line's "separable" key.
- FLOPs a point are analytic (``flops_source``): ``analytic_flops_per_point``
  (a copy of ``bench.py``'s) for the symmetric family,
  ``separable_flops_per_point`` for the separable one.
- ``peak_fraction`` is against the card's float32 FMA ceiling, measured by
  the dependent FMA chain of ``csrc/ceiling.cu`` (``measure_ceilings``,
  ``peak_source`` "measured_fma_chain"); the tanh chain gives the
  transcendental ceiling. Eager torch chains would time one launch per
  operation, i.e. the memory, so the chains are a kernel. A reading above
  105% of the H100's published 67 TFLOP/s is a broken kernel and raises.
- ``vs_baseline``: ours over the reference-style step (float64, nested
  autograd Laplacian) on the host's CPU (``measure_torch_baseline``),
  cached in ``bench_baseline_torch.json`` at the checkout's root when the
  host was idle.

Nothing falls back: a kernel that cannot be built or launched raises, and
without CUDA the line needs ``--device cpu``. The JAX bench's ``--kernel``
and ``--remat`` have no counterpart (the device decides the path).

    python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.cli bench \\
        [--n N] [--steps K] [--dtype float32] [--arch A] [--repeats R] \\
        [--no-baseline] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .device import DEVICE_HELP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_CACHE = os.path.join(ROOT, "bench_baseline_torch.json")
# the H100 SXM's published float32 rate outside the tensor cores (FLOP/s)
H100_FP32_PEAK = 67e12
# the ceiling chains' sizes: elements, loop iterations of the FMA and of the
# tanh chain (about 40 ms each on an H100; the plain versions on the CPU
# are eager loops, so they run a token size)
CEILING_SIZES = {"cuda": dict(n=1 << 20, iters_fma=8192, iters_tanh=2048),
                 "cpu": dict(n=1024, iters_fma=2, iters_tanh=2)}
# timed calls of each chain; the best one counts
CEILING_REPEATS = 3


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_ours(n: int, steps: int, dtype: str, arch: str = "symmetric",
                 repeats: int = 3, device="cuda") -> dict:
    """Points/s of the training step of ``arch`` at ``n`` points a step."""
    import dataclasses

    import torch

    from .config import Config, ModelConfig
    from .device import resolve_device
    from .ops.sampling import sample_batch
    from .training import engine

    dev = resolve_device(device)
    cfg = Config(dtype=dtype, model=ModelConfig(arch=arch))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, n_train=n, epochs=10 ** 9, scan_chunk=steps))
    gen = torch.Generator(device=dev).manual_seed(0)
    trainer = engine.Trainer(cfg, generator=gen, device=dev)

    def sample(g):
        return sample_batch(g, cfg, device=dev)

    trainer.batch = sample(gen)

    def chunk() -> float:
        for _ in range(steps):
            hist = trainer.advance(sample)
        _sync(dev)
        return float(hist.l_tot)

    chunk()                                    # warm-up (kernel build, caches)
    times = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        loss = chunk()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    flops = (separable_flops_per_point(cfg) if arch == "separable"
             else analytic_flops_per_point(cfg))
    return {
        "points_per_sec": n * steps / dt,
        "points_per_sec_median": n * steps / sorted(times)[len(times) // 2],
        "points_per_sec_worst": n * steps / max(times),
        "timed_chunks": len(times),
        "steps_per_sec": steps / dt,
        "n": n, "steps": steps, "dtype": dtype,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "final_loss": loss,
        "flops_per_point": flops,
        "flops_source": "analytic",
        # the minimal family takes the plain forward-Laplacian pass
        "kernel": ("cuda" if dev.type == "cuda" and arch != "minimal"
                   else "plain"),
    }


def analytic_flops_per_point(cfg) -> float:
    """Analytic FLOPs per collocation point for one fused TRAIN step
    (forward-Laplacian pass + reverse-mode backward ~ 2x forward + Adam).

    Forward counts (symmetric arch, width H, E-head He, gate Hg), per point:
    4 orbital envelopes ~30 each; correction MLP propagating the
    (v, gx, gy, gz, l) 5-tuple through 2->H->H->1 twice (mirrored branch);
    R-heads; residual/loss assembly. Multiply-add counted as 2 FLOPs.
    """
    h = cfg.model.hidden
    he, hg = cfg.model.hidden_e, cfg.model.hidden_gate
    env = 4 * 30
    layer1 = 2 * h * 46            # 2 branches: per-unit 5-comp FMA + sig123
    layer2 = 2 * h * (10 * h + 26)
    out = 2 * 10 * h
    gate = hg * 8
    ehead = he * 6 + 2 * he * he + 2 * he
    fwd = env + layer1 + layer2 + out + gate + ehead + 30
    return 3.0 * fwd + 18.0        # bwd ~ 2x fwd; Adam ~ 18 flops/param<<n


def separable_flops_per_point(cfg) -> float:
    """Analytic FLOPs per collocation point of one separable train step
    (width H, E head He, alpha(R) and b(R) heads Ha; multiply-add = 2):

    - K1-fwd's 12H^2 + 58H + 117 and K1-bwd's 36H^2 + 178H + 236 operations
      a point (PERF.md, section 6: psi and lap psi of the GZ envelope pair
      times the two width-H tanh MLPs, and their weight cotangents);
    - the rest of the step, forward ~ 1/3 of forward + backward as in
      ``analytic_flops_per_point``: the E head He*6 + 2 He^2 + 2 He, the
      alpha(R) and b(R) heads 1 -> Ha -> 1 at 8 Ha each (counted as that
      function counts the gate), and the residual and loss assembly 30;
    - Adam, 18.

    16 417 + 3 x 2 462 + 18 = 23 821 at the defaults (H 16, He 32, Ha 8).
    """
    h = cfg.model.hidden
    he, ha = cfg.model.hidden_e, cfg.model.hidden_alpha
    k1_fwd = 12 * h * h + 58 * h + 117
    k1_bwd = 36 * h * h + 178 * h + 236
    ehead = he * 6 + 2 * he * he + 2 * he
    heads = 2 * ha * 8
    return k1_fwd + k1_bwd + 3.0 * (ehead + heads + 30) + 18.0


def measure_ceilings(device="cuda") -> dict:
    """The float32 FMA ceiling (FLOP/s) and tanh ceiling (ops/s) of the
    device at ``CEILING_SIZES``: the best of ``CEILING_REPEATS`` timed calls
    of each chain of ``ops.ceiling`` after one warm-up call (CUDA events on
    the card, the host clock on the CPU). Raises if the FMA reading on the
    card is above 105% of the H100's published float32 peak."""
    import torch

    from .device import resolve_device
    from .ops import ceiling

    dev = resolve_device(device)
    sizes = CEILING_SIZES[dev.type]
    gen = torch.Generator(device=dev).manual_seed(0)
    x0 = torch.rand(sizes["n"], generator=gen, device=dev)
    a, b = 0.9999, 1e-6

    def seconds(which, iters) -> float:
        def call():
            return ceiling.chain(x0, iters, a, b, which)
        call()
        best = float("inf")
        for _ in range(CEILING_REPEATS):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call()
                end.record()
                torch.cuda.synchronize(dev)
                best = min(best, start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                call()
                best = min(best, time.perf_counter() - t0)
        return best

    fma = ceiling.operations(sizes["n"], sizes["iters_fma"], "fma") \
        / seconds("fma", sizes["iters_fma"])
    tanh = ceiling.operations(sizes["n"], sizes["iters_tanh"], "tanh") \
        / seconds("tanh", sizes["iters_tanh"])
    if dev.type == "cuda" and fma > 1.05 * H100_FP32_PEAK:
        raise RuntimeError(
            f"the FMA chain read {fma / 1e12:.1f} TFLOP/s, above 105% of "
            f"the H100's {H100_FP32_PEAK / 1e12:.0f} TFLOP/s float32 peak: "
            "the ceiling kernel is broken")
    return {"fma_flops_per_sec": fma, "tanh_ops_per_sec": tanh,
            "n": sizes["n"], "iters_fma": sizes["iters_fma"],
            "iters_tanh": sizes["iters_tanh"], "chains": ceiling.CHAINS,
            "unroll_fma": ceiling.UNROLL["fma"],
            "unroll_tanh": ceiling.UNROLL["tanh"]}


def measure_torch_baseline(n: int = 10_000, steps: int = 3) -> dict:
    """Reference-style step on CPU torch: float64, nested autograd Laplacian.

    This is NOT the reference's unrecorded GPU number — it is the only
    measurable baseline in this environment, labeled as such. (The root
    bench.py's step; its draws come from a seeded generator here, and the
    process's default dtype and global seed are left alone.)
    """
    import numpy as np
    import torch

    f64 = torch.float64
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, dtype=f64)

    def mk(shape_in, shape_out):
        b = 1.0 / shape_in ** 0.5
        w = ((rand(shape_in, shape_out) * 2 - 1) * b).requires_grad_()
        bias = ((rand(shape_out) * 2 - 1) * b).requires_grad_()
        return w, bias

    h1 = mk(2, 16); h2 = mk(16, 16); out = mk(16, 1)   # noqa: E702
    g1 = mk(1, 10); g2 = mk(10, 1)                      # noqa: E702
    e1 = mk(1, 32); e2 = mk(32, 32); e3 = mk(32, 1)     # noqa: E702
    params = [t for pair in (h1, h2, out, g1, g2, e1, e2, e3) for t in pair]
    optim = torch.optim.Adam(params, lr=8e-3)

    def second(f, v):
        d1 = torch.autograd.grad(f.sum(), v, create_graph=True)[0]
        return torch.autograd.grad(d1.sum(), v, create_graph=True)[0]

    times = []
    for _ in range(steps + 1):
        t0 = time.perf_counter()
        optim.zero_grad()
        x = (rand(n, 1) * 36 - 18).requires_grad_()
        y = (rand(n, 1) * 36 - 18).requires_grad_()
        z = (rand(n, 1) * 36 - 18).requires_grad_()
        R = rand(n, 1) * 3.8 + 0.2
        r1 = torch.sqrt((x - R) ** 2 + y ** 2 + z ** 2)
        r2 = torch.sqrt((x + R) ** 2 + y ** 2 + z ** 2)
        f1, f2 = torch.exp(-r1), torch.exp(-r2)
        h = torch.sigmoid(torch.cat([f1, f2], 1) @ h1[0] + h1[1])
        h = torch.sigmoid(h @ h2[0] + h2[1])
        nn = (2 * h) @ out[0] + out[1]
        gate = torch.sigmoid(R @ g1[0] + g1[1]) @ g2[0] + g2[1]
        e = torch.sigmoid(R @ e1[0] + e1[1])
        e = torch.sigmoid(e @ e2[0] + e2[1]) @ e3[0] + e3[1]
        psi = f1 + f2 + nn * gate
        lap = second(psi, x) + second(psi, y) + second(psi, z)
        res = -0.5 * lap + (-1 / r1 - 1 / r2 - e) * psi
        loss = (res ** 2).mean() + (psi[r1 > 17.5] ** 2).mean()
        loss.backward()
        optim.step()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times[1:]))
    return {"points_per_sec": n / dt, "n": n, "device": "cpu-torch-f64"}


def load_baseline(cache: str = BASELINE_CACHE) -> dict | None:
    """The cached baseline, else a fresh measurement, cached only when the
    host was idle (the root bench.py's rule); None if it cannot be
    measured."""
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)
    try:
        # the torch step runs on the HOST CPU: a concurrent job slows it and
        # inflates vs_baseline, so only a measurement taken on an idle host
        # (load average below 0.5) is cached
        load = os.getloadavg()[0]
        baseline = measure_torch_baseline()
        if load < 0.5:
            with open(cache, "w") as f:
                json.dump(baseline, f)
        else:
            print(f"host loadavg {load:.1f} >= 0.5: baseline measured "
                  "under contention, NOT cached (vs_baseline may be "
                  "inflated this run)", file=sys.stderr)
        return baseline
    except Exception as exc:
        print(f"baseline measurement failed: {exc}", file=sys.stderr)
        return None


def bench_line(ours: dict, ceilings: dict, baseline: dict | None,
               separable: dict | None = None) -> dict:
    """The root bench.py's output line from the measurements."""
    peak_flops = ceilings["fma_flops_per_sec"]
    vs = (ours["points_per_sec"] / baseline["points_per_sec"]
          if baseline else 1.0)
    achieved = ours["points_per_sec"] * ours["flops_per_point"]
    out = {
        "metric": "collocation_points_per_sec",
        "value": round(ours["points_per_sec"], 1),
        "unit": "points/s",
        "vs_baseline": round(vs, 2),
        "flops_per_point": round(ours["flops_per_point"], 1),
        "flops_source": ours["flops_source"],
        "achieved_gflops": round(achieved / 1e9, 2),
        "peak_fraction": round(achieved / peak_flops, 4),
        "peak_source": "measured_fma_chain",
        "ceiling_fma_gflops": round(ceilings["fma_flops_per_sec"] / 1e9, 1),
        "ceiling_tanh_gops": round(ceilings["tanh_ops_per_sec"] / 1e9, 1),
        "kernel": ours["kernel"],
        "value_median": round(ours["points_per_sec_median"], 1),
        "value_worst": round(ours["points_per_sec_worst"], 1),
        "timed_chunks": ours["timed_chunks"],
    }
    if separable is not None:
        achieved = separable["points_per_sec"] * separable["flops_per_point"]
        out["separable"] = {
            "points_per_sec": round(separable["points_per_sec"], 1),
            "points_per_sec_median": round(
                separable["points_per_sec_median"], 1),
            "flops_per_point": round(separable["flops_per_point"], 1),
            "achieved_gflops": round(achieved / 1e9, 2),
            "peak_fraction": round(achieved / peak_flops, 4),
        }
    return out


def add_arguments(ap: argparse.ArgumentParser) -> None:
    """The bench's flags (the root bench.py's, but --kernel and --remat,
    plus --device)."""
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--arch", default=None,
                    choices=["symmetric", "minimal", "separable"],
                    help="model family for the measured train step. Default: "
                         "measure BOTH the reference-parity symmetric family "
                         "(K2) and the separable flagship (K1), in one JSON "
                         "line")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed chunks per arch; best is reported, "
                         "median/worst recorded as dispersion")
    ap.add_argument("--no-baseline", action="store_true",
                    dest="no_baseline")
    ap.add_argument("--device", default="cuda",
                    help=DEVICE_HELP)


def run(args) -> dict:
    """Measure, print the one JSON line, and return it."""
    ours = measure_ours(args.n, args.steps, args.dtype,
                        args.arch or "symmetric", repeats=args.repeats,
                        device=args.device)
    separable = None
    if args.arch is None:
        separable = measure_ours(args.n, args.steps, args.dtype, "separable",
                                 repeats=args.repeats, device=args.device)
    ceilings = measure_ceilings(args.device)
    baseline = None if args.no_baseline else load_baseline()
    out = bench_line(ours, ceilings, baseline, separable)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m pinn_for_quantum_wavefunction_surfaces_tpu_torch.bench",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arguments(ap)
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
