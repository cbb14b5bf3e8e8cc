"""The readings a cell's limits are set from, on the chip at the cell's
own size.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 ... \\
        --controls 101 102 103

For each of ``--seeds``: the program's first steps against the reference
(``harness.program_record`` and ``reference_record``), the lower reading
of each number. For each of ``--controls``: the reference put in the
program's place, in the next precision below the cell's
(``check.CONTROL``), and the reference with half of each batch left out
(the mean taken over the rest), each against the float64 reference: the
upper readings. A state left unchanged reads 1 on ``change`` and needs no
run. With ``--drawn`` each seed's weights are drawn apart (``weights.make``
with ``base`` the seed) where a run only permutes one draw's units: the
readings then span networks that differ. One JSON line a reading, then a
summary line; nothing times.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--controls", type=int, nargs="*", default=[])
    p.add_argument("--drawn", action="store_true",
                   help="draw each seed's weights apart")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from . import check, harness, weights
    cell = harness.resolve(args.workload, harness.benchmark())
    dev = torch.device(args.device)
    dtype = getattr(torch, cell.traffic["dtype"])
    lower, upper = {}, {}

    def base(seed):
        return seed if args.drawn else None

    def emit(kind, seed, g):
        print(json.dumps({"workload": cell.name, "reading": kind,
                          "seed": seed, "drawn": args.drawn, **g}),
              flush=True)
        into = lower if kind == "program" else upper
        for k, v in g.items():
            into.setdefault(k, []).append(v)

    for seed in args.seeds:
        mix, rec, start = harness.program_record(cell, seed, dev, base(seed))
        del mix
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        emit("program", seed, check.gaps(rec, harness.reference_record(
            cell, seed, start, dev)))
    ctl_type, ctl_tf32 = check.CONTROL[cell.traffic["dtype"]]
    for seed in args.controls:
        start = weights.make(cell.config["model"], seed, dtype, dev,
                             base(seed))
        ref = harness.reference_record(cell, seed, start, dev)
        ctl = harness.reference_record(cell, seed, start, dev,
                                       getattr(torch, ctl_type),
                                       use_tf32=ctl_tf32)
        emit(f"control {ctl_type}{' tf32' if ctl_tf32 else ''}", seed,
             check.gaps(ctl, ref))
        half = harness.reference_record(cell, seed, start, dev, dtype,
                                        keep=0.5)
        emit("half batch", seed, check.gaps(half, ref))
    print(json.dumps({"workload": cell.name, "summary": {
        k: {"lower_max": max(lower.get(k, [float("nan")])),
            "upper_min": min(upper.get(k, [float("nan")]))}
        for k in set(lower) | set(upper)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
