"""The reference against the program's CPU path at smoke size, and the
comparison failing where the timed path is broken underneath: a step
that leaves the state unchanged, half of each batch left out, and the
reference in a lower precision put in the program's place."""

import math

import pytest
import torch

from portbench import check, harness, program, weights
from portbench.tests.smoke import CELLS, cell

SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_program(name):
    c = cell(name)
    mix, rec, start = harness.program_record(c, SEED, "cpu")
    ref = harness.reference_record(c, SEED, start, "cpu")
    assert len(rec["loss"]) == len(ref["loss"]) == harness.RECORD_STEPS
    g = check.gaps(rec, ref)
    ok, checks = check.decide(g, c.limits)
    assert ok, checks
    if c.traffic["dtype"] == "float64":
        # the plain path in float64 against the reference: rounding
        assert g["loss"] < 1e-13 and g["grad"] < 1e-12, g


@pytest.mark.parametrize("name", CELLS)
def test_a_run_on_the_cpu_is_correct(name):
    res, checks = harness.run(cell(name), SEED + 1, 0.3, False, "cpu",
                              log=lambda *a, **k: None)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"points_per_s", "setup_s"}


def unchanged(monkeypatch):
    """Adam leaves the params where they are."""
    engine = program.module("training.engine")
    monkeypatch.setattr(engine.Adam, "step", lambda self, grad: None)


def half_batch(monkeypatch):
    """The objectives see the first half of each row (of the points), the
    means taken over them."""
    v = program.module("training.variational")
    engine = program.module("training.engine")
    quotient, loss = v.quotient_loss, engine.Trainer.loss

    def q(params, cfg, vb, *a, **k):
        n = vb.x.shape[1] // 2
        return quotient(params, cfg, v.VBatch(*(t[:, :n] for t in vb[:4]),
                                              vb.r), *a, **k)

    def r(params, cfg, batch, *a, **k):
        n = batch.x.shape[0] // 2
        return loss(params, cfg, type(batch)(*(t[:n] for t in batch)), *a,
                    **k)

    monkeypatch.setattr(v, "quotient_loss", q)
    monkeypatch.setattr(engine.Trainer, "loss", staticmethod(r))


@pytest.mark.parametrize("fault", [unchanged, half_batch])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res, checks = harness.run(cell(name), SEED + 2, 0.3, False, "cpu",
                              log=lambda *a, **k: None)
    assert res["correct"] is False, checks


def control(name, device):
    c = cell(name)
    dtype = getattr(torch, c.traffic["dtype"])
    start = weights.make(c.config["model"], SEED + 3, dtype, device)
    ref = harness.reference_record(c, SEED + 3, start, device)
    low, tf32 = check.CONTROL[c.traffic["dtype"]]
    ctl = harness.reference_record(c, SEED + 3, start, device,
                                   getattr(torch, low), use_tf32=tf32)
    return check.decide(check.gaps(ctl, ref), c.limits)


@pytest.mark.parametrize("name", [n for n in CELLS
                                  if cell(n).traffic["dtype"] == "float64"])
def test_the_lower_precision_control_is_not_correct(name):
    ok, checks = control(name, "cpu")
    assert not ok, checks


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_the_lower_precision_control_is_not_correct_on_the_card(name, card):
    ok, checks = control(name, card)
    assert not ok, checks


def test_a_number_that_is_not_finite_fails():
    ok, _ = check.decide({"loss": math.nan}, {"loss": {"limit": 1.0}})
    assert not ok
    ok, _ = check.decide({}, {"loss": {"limit": 1.0}})
    assert not ok


def test_roundoff_leaves_are_left_out_of_the_change():
    steps = {"a": [1.0, 1.0], "b": [2.0, 2.0], "c": [0.0, 1.0],
             "d": [1e-9, 1.0], "e": [1.0, 1e-7]}
    assert check.decided(steps) == ["a", "b", "c"]
