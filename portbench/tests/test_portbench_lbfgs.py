"""The ``lbfgs`` traffic kind: the polish's L-BFGS taken a step at a time,
its evaluations counted, its first evaluation held to the reference."""

import json

import pytest

from portbench import check, harness, mixes
from portbench.tests.smoke import cell

SEED = 2 ** 31 + 999


@pytest.fixture
def lbfgs_cell():
    c = cell("flagship-separable.polish-adam")
    c.traffic = json.loads((harness.HERE / "traffic/lbfgs.json").read_text())
    c.traffic.update(n_r=3, n_xi=8, n_eta=6, read_every=2)
    c.kind = mixes.load(c.traffic["kind"])
    return c


def test_lbfgs_steps_and_counts(lbfgs_cell):
    mix, rec, start = harness.program_record(lbfgs_cell, SEED, "cpu")
    assert mix.evaluations >= harness.RECORD_STEPS
    values = []
    for _ in range(4):
        mix.step()
        values.append(mix.loss())
    # a strong-Wolfe step descends: the objective where each step starts
    assert all(b <= a + 1e-12 for a, b in zip(values, values[1:])), values
    assert mix.read() < 0.0                  # the validation quotient
    notes = mix.notes()
    assert notes["evaluations_per_step"] >= 1.0
    assert mix.points == 3 * (8 * 6 + 25 * 19)      # the grids' points
    assert mix.kernel_points == 2 * 3 * 25 * 19     # padded to rows of 25x19
    ref = harness.reference_record(lbfgs_cell, SEED, start, "cpu")
    g = check.gaps(rec, ref)
    assert set(g) == {"loss", "grad"}
    assert g["loss"] < 1e-13 and g["grad"] < 1e-12, g
