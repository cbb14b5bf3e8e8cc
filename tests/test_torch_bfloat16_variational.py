"""``cli variational``, ``distill`` and ``evaluate`` under ``--dtype
bfloat16`` against the JAX CLI, on the CPU at smoke sizes (the helpers and
conventions of test_torch_bfloat16_cli.py). Both packages' E-head fits
take 200 L-BFGS steps instead of 8 000: a bfloat16 fit stops improving
within the first 200 in both, and the 8 000 take the port two minutes on
the CPU in bfloat16. torch runs on one thread."""

import functools
import os

import numpy as np
import pytest

from pinn_for_quantum_wavefunction_surfaces_tpu.training import \
    distill as jdistill
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
    checkpoint as tckpt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    distill as tdistill

from test_torch_bfloat16_cli import (assert_bf16_checkpoints_alike,
                                     raw_leaves, run_both)
from test_torch_excited import one_torch_thread  # noqa: F401
from test_torch_separable import ARTIFACTS, no_jax_cache_writes  # noqa: F401

FIT_LBFGS_STEPS = 200


@pytest.fixture
def short_fit(monkeypatch):
    """Both packages' E-head fits at FIT_LBFGS_STEPS L-BFGS steps."""
    for mod in (jdistill, tdistill):
        monkeypatch.setattr(mod, "fit_energy_head", functools.partial(
            mod.fit_energy_head, lbfgs_steps=FIT_LBFGS_STEPS))


VARIATIONAL_CASES = {
    "mc": [os.path.join(ARTIFACTS, "flagship.npz"), "--n-r", "2",
           "--n-pts", "64", "--epochs", "2"],
    "lbfgs": [os.path.join(ARTIFACTS, "flagship_separable.npz"), "--lbfgs",
              "2", "--n-r", "2", "--n-pts", "64"],
    "spheroidal": ["--arch", "separable", "--spheroidal", "--adam-warmup",
                   "2", "--lbfgs", "2", "--n-r", "2", "--n-xi", "8",
                   "--n-eta", "6"],
}


@pytest.mark.parametrize("case", list(VARIATIONAL_CASES))
def test_cli_variational_bfloat16(case, tmp_path, capsys,
                                  one_torch_thread):  # noqa: F811
    """cli variational under --dtype bfloat16 (the Monte-Carlo trainer,
    --lbfgs, the --spheroidal polish): the JAX CLI's keys, the same
    checkpoint layout of 2-byte leaves, finite values."""
    outs = run_both(tmp_path, capsys, "variational",
                    VARIATIONAL_CASES[case])
    got, want = outs["port"][0], outs["jax"][0]
    # the port's polish line names its device too
    assert sorted(set(got) - {"device"}) == sorted(want)
    if "E_mean_final" in got:
        assert np.isfinite(got["E_mean_final"])
    for name in ("variational.npz",) + (("variational_raw.npz",)
                                        if case == "mc" else ()):
        port = os.path.join(outs["port"][1], name)
        assert_bf16_checkpoints_alike(port,
                                      os.path.join(outs["jax"][1], name))
        bits = [a.view(np.int16).astype(np.uint16).astype(np.uint32) << 16
                for a in raw_leaves(port).values()
                if a.dtype == tckpt.BFLOAT16_BITS]
        assert all(np.isfinite(b.view(np.float32)).all() for b in bits)


def test_cli_distill_and_evaluate_bfloat16(tmp_path, capsys, short_fit,
                                           one_torch_thread):  # noqa: F811
    """cli distill and cli evaluate of flagship.npz under --dtype bfloat16:
    the JAX CLI's keys and layout; evaluate's mean errors within 1 mHa of
    the JAX CLI's, its largest within one bfloat16 spacing of the targets
    (E_net is the bfloat16 head evaluated at a float32 R, as JAX's float32
    R promotes it)."""
    src = os.path.join(ARTIFACTS, "flagship.npz")
    outs = run_both(tmp_path / "d", capsys, "distill",
                    [src, "--n-test", "12", "--steps", "20"],
                    out_is_file=True)
    assert sorted(outs["port"][0]) == sorted(outs["jax"][0])
    assert_bf16_checkpoints_alike(outs["port"][1], outs["jax"][1])
    outs = run_both(tmp_path / "e", capsys, "evaluate",
                    [src, "--n-test", "12", "--steps", "20",
                     "--table-knots", "0", "--oracle", "wind"])
    got, want = outs["port"][0], outs["jax"][0]
    assert list(got) == list(want)
    for k in ("mean_err_mHa", "mean_err_mHa_R>=0.5", "int_mean_err_mHa"):
        assert abs(got[k] - want[k]) <= 1.0, (k, got[k], want[k])
    # a largest error is one R's: the head fits quotients that bfloat16
    # rounds to 2^-7 Ha (7.8 mHa) where |E| >= 1 Ha (R < 0.6), and the two
    # packages' optimisers land differently within that spacing (4.73 and
    # 2.57 mHa at R = 0.2 on this tree)
    for k in ("max_err_mHa", "max_err_mHa_R>=0.5", "int_max_err_mHa"):
        assert abs(got[k] - want[k]) <= 1e3 * 2.0 ** -7, (k, got[k],
                                                          want[k])
    assert_bf16_checkpoints_alike(
        os.path.join(outs["port"][1], "evaluated.npz"),
        os.path.join(outs["jax"][1], "evaluated.npz"))
