"""Smoke sizes of the cells for the CPU tests: the same kinds, configurations
and limits, a few points."""

from portbench import harness

SMALL = {"flagship-separable.polish-adam": {"n_r": 3, "n_xi": 8, "n_eta": 6,
                                            "read_every": 4},
         "flagship-separable.mc": {"n_r": 4, "n_pts": 512, "read_every": 4},
         "paper-symmetric-gz.train": {"read_every": 4,
                                      "train": {"n_train": 2048}}}
CELLS = sorted(SMALL)


def cell(name: str):
    """The cell ``name`` of BENCHMARK.json at smoke size."""
    c = harness.resolve(name, harness.benchmark())
    for k, v in SMALL[name].items():
        c.traffic[k] = {**c.traffic[k], **v} if isinstance(v, dict) else v
    return c
