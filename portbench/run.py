"""One run of one cell of the benchmark of the PyTorch and CUDA port.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. Prints
earlier lines on standard error (the run's counts, the program's and the
reference's readings), then each number compared beside its limit as the
last lines there, and the result as one JSON object, the last line on
standard output. Exits non-zero, printing no result, without CUDA or with
fewer cards than the cell asks for, when the process holds JAX or the JAX
package, or when anything of the run fails.
"""

from __future__ import annotations

import os
import time

_T0 = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (from /proc where it can be
    read; else since this module was loaded)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    from pathlib import Path

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    # the caches of anything that compiles stay at fixed paths inside the
    # checkout (the program's own kernels go to build/kernels there)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(root / "build" / sub))
    os.environ.setdefault("OMP_NUM_THREADS", "2")

    from . import harness
    cell = harness.resolve(args.workload, harness.benchmark(root))
    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, checks = harness.run(cell, args.seed, args.seconds,
                                 bool(args.trace), "cuda",
                                 started=process_age)
    found = harness.forbidden_modules()
    if found:
        print("portbench: the process holds " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
