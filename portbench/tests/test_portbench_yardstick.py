"""The frozen copies of the operation counts, bounds and model FLOPs equal
what the program's ``bench.py`` and ``chip_smoke.py`` give today."""

import importlib.util
from pathlib import Path

import pytest

from portbench import program, yardstick

ROOT = Path(yardstick.__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_copy",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("h", [4, 8, 16, 32])
def test_operation_counts(chip_smoke, h):
    assert yardstick.k1_fwd_ops(h) == chip_smoke.fwd_ops(h)
    assert yardstick.k1_bwd_ops(h) == chip_smoke.bwd_ops(h)
    assert yardstick.k2_fwd_ops(h) == chip_smoke.train_fwd_ops(h)
    assert yardstick.k2_bwd_ops(h) == chip_smoke.train_bwd_ops(h)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("n", [100_000, 164_502, 1_048_576])
def test_bounds(chip_smoke, kernel, which, dtype, n):
    assert yardstick.bound_ms(n, 16, dtype, which, kernel) == \
        chip_smoke.bound_ms(n, 16, dtype, which, kernel)


def test_peaks(chip_smoke):
    assert (yardstick.PEAK_FP64_PRODUCTS, yardstick.PEAK_FP64_OTHER,
            yardstick.PEAK_FP32, yardstick.PEAK_BF16_PRODUCTS,
            yardstick.PEAK_BYTES) == (
        chip_smoke.PEAK_FP64_PRODUCTS, chip_smoke.PEAK_FP64_OTHER,
        chip_smoke.PEAK_FP32, chip_smoke.PEAK_BF16_PRODUCTS,
        chip_smoke.PEAK_BYTES)


@pytest.mark.parametrize("hidden", [8, 16, 32])
def test_model_flops(hidden):
    bench = program.module("bench")
    config = program.module("config")
    sym = config.Config(model=config.ModelConfig(hidden=hidden))
    sep = config.Config(model=config.ModelConfig(arch="separable",
                                                 hidden=hidden))
    m = {"hidden": hidden, "hidden_e": 32, "hidden_gate": 10,
         "hidden_alpha": 8}
    assert yardstick.flops_per_point({**m, "arch": "symmetric"}) == \
        bench.analytic_flops_per_point(sym)
    assert yardstick.flops_per_point({**m, "arch": "separable"}) == \
        bench.separable_flops_per_point(sep)
    if hidden == 16:
        assert bench.separable_flops_per_point(sep) == 23_821


def test_quotient_step_counts_the_energy_head_once_a_row():
    """A quotient step evaluates E(R) once an R row, not at every point:
    the residual count a point less the head's forward and backward, and
    the head's once a row."""
    m = {"arch": "separable", "hidden": 16, "hidden_e": 32,
         "hidden_alpha": 8}
    assert yardstick.ehead_flops(32) == 2_304
    assert yardstick.step_flops(m, "residual", 1000, 7) == 1000 * 23_821
    assert yardstick.step_flops(m, "quotient", 119_691, 78) == \
        119_691 * (23_821 - 6_912) + 78 * 6_912
    with pytest.raises(ValueError):
        yardstick.step_flops(m, "surface", 1, 1)


def test_dual_grid_points_leave_the_padding_out():
    """The polish cell's points: 39 R rows of 40 x 24 and 57 x 37 Gauss
    points, the first grid's padding to 57 x 37 not counted; at smoke size
    the count equals the reference batch's points of nonzero weight."""
    import torch

    from portbench.reference import sampling
    assert sampling.dual_grid_points(39, 40, 24) == 119_691
    dom = {"r_lo": 0.2, "r_hi": 4.0, "xi_span": 20.0}
    w = sampling.dual_grid(dom, 3, 8, 6, torch.float64, "cpu")[3]
    assert w.numel() == 2 * 3 * 25 * 19
    assert int((w != 0).sum()) == sampling.dual_grid_points(3, 8, 6)
