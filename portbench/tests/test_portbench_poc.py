"""The ``poc_residual`` traffic kind: the residual trainer on the paper's
own network, the alpha(R) and b(R) layers of the harness's draw stripped
on both sides, its first steps held to ``reference/poc.py``; and the
per-layer metrics of its cell."""

import pytest
import torch

from portbench import check, harness
from portbench.mixes import poc_residual
from portbench.reference import follow, objectives, poc

SEED = 2 ** 31 + 888
N = 1024


@pytest.fixture
def poc_cell():
    c = harness.resolve("paper-poc.train-f64", harness.benchmark())
    c.traffic["read_every"] = 4
    c.traffic["train"] = {**c.traffic["train"], "n_train": N}
    return c


def test_poc_residual_steps_on_the_stripped_tree(poc_cell):
    mix, rec, start = harness.program_record(poc_cell, SEED, "cpu")
    kept = poc_residual.strip(start)
    assert set(start) - set(kept) == set(poc_residual.HEADS)
    assert set(mix.tr.layout.tree(mix.tr.flat)) == set(kept)
    assert mix.points == mix.kernel_points == N
    assert {n.split("/")[0] for n in rec["grad"]} == set(kept)
    for _ in range(4):
        mix.step()
    assert mix.read() == mix.loss()
    ref = harness.reference_record(poc_cell, SEED, start, "cpu")
    g = check.gaps(rec, ref)
    assert set(g) == {"loss", "grad", "change"}
    assert g["loss"] < 1e-13 and g["grad"] < 1e-12 and g["change"] < 1e-11, g
    ok, checks = check.decide(g, poc_cell.limits)
    assert ok, checks


def test_the_gz_familys_reference_is_not_the_cells(poc_cell):
    """The drawn tree unstripped, followed by the GZ family's reference
    (alpha(R) and b(R) on, b = 0.1 at init) on the cell's last batch:
    another function, whose loss lies far from the cell's."""
    mix, _, start = harness.program_record(poc_cell, SEED + 1, "cpu")
    first = tuple(t.clone() for t in mix.tr.batch)
    ours = follow(poc_residual.strip(start), torch.float64, 1,
                  lambda i: first, lambda p, b: poc.residual(p, b),
                  lambda i: 0.008)
    gz = follow(start, torch.float64, 1, lambda i: first,
                lambda p, b: objectives.residual("symmetric", p, b),
                lambda i: 0.008)
    assert abs(gz["loss"][0] - ours["loss"][0]) > 1e-3 * ours["loss"][0]


def test_the_cell_reports_its_metrics():
    cell = harness.resolve("paper-poc.train-f64", harness.benchmark())
    assert set(cell.per_layer) == {
        "k2_roofline", "host_us_per_step", "kernel_launches_per_step",
        "torch_ops_ms_per_step", "mfu", "device_idle_share",
        "sample_ms_per_step", "forward_ms_per_step", "backward_ms_per_step",
        "update_ms_per_step", "launch_wait_share"}
    assert cell.limits
