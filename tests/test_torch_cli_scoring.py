"""The scoring subcommands of the port's CLI (energy, distill, evaluate) on
the CPU at tiny sizes, and the reference's .pt checkpoints.

``cli energy`` on a reference-parity .npz and on a .pt written by the JAX
package's ``save_reference_checkpoint`` prints the JAX ``cli energy``'s JSON
and writes its pickle (values to rtol 1e-12, float64); ``cli evaluate`` and
``cli distill`` write the JAX package's files, meta and JSON keys; what the
port cannot score yet exits with a message."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu import cli as jcli
from pinn_for_quantum_wavefunction_surfaces_tpu.io import checkpoint as jckpt
from pinn_for_quantum_wavefunction_surfaces_tpu.io import torch_pt as jpt
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import cli
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
    torch_pt as tpt

from test_torch_separable import (ARTIFACTS, load_artifact,  # noqa: F401
                                  no_jax_cache_writes)

EVALUATE_KEYS = [
    "checkpoint", "oracle", "fit_rms_mHa", "mean_err_mHa", "max_err_mHa",
    "mean_err_mHa_R>=0.5", "max_err_mHa_R>=0.5", "err_R=0.2",
    "int_mean_err_mHa", "int_max_err_mHa", "int_min_signed_mHa"]
TABLE_KEYS = ["tab_mean_err_mHa", "tab_max_err_mHa",
              "tab_offknot_mean_err_mHa", "tab_offknot_max_err_mHa"]


def ref_params(seed=5):
    """Reference-parity params drawn by the JAX package (numpy, float64)."""
    return jax.tree.map(np.asarray, jans.init_params(
        jax.random.PRNGKey(seed), pqs.ModelConfig(), jnp.float64))


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_cli_energy_matches_jax(fmt, tmp_path, capsys):
    params = ref_params()
    ck = str(tmp_path / f"model.{fmt}")
    if fmt == "npz":
        jckpt.save(ck, {"params": params}, meta={})
    else:
        jpt.save_reference_checkpoint(ck, params)
    flags = ["--n-test", "16", "--r-lo", "0.9", "--r-hi", "1.2"]
    jcli.main(["energy", ck, "--out", str(tmp_path / "j.pkl")] + flags)
    want = last_json(capsys)
    cli.main(["energy", ck, "--out", str(tmp_path / "t.pkl"), "--device",
              "cpu"] + flags)
    got = last_json(capsys)
    assert got.pop("surface").endswith("t.pkl")
    assert want.pop("surface").endswith("j.pkl")
    assert got == want
    with open(tmp_path / "j.pkl", "rb") as f:
        sj = pickle.load(f)
    with open(tmp_path / "t.pkl", "rb") as f:
        st = pickle.load(f)
    assert sorted(st) == sorted(sj) == ["E_int", "E_net", "Elcao", "R"]
    np.testing.assert_array_equal(st["R"], sj["R"])
    assert len(st["R"]) == 4
    for k in ("E_int", "Elcao", "E_net"):
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-12)


def test_pt_checkpoints_cross_the_packages(tmp_path):
    """A .pt the port writes reads in the JAX package and the reference's
    layout; one the JAX package writes reads in the port."""
    params = ref_params(seed=6)
    path = str(tmp_path / "port.pt")
    tpt.save_reference_checkpoint(path, params)
    sd = torch.load(path, weights_only=True)["model_state_dict"]
    assert sd["Lin_H1.weight"].shape == (16, 2)
    assert sd["netDecay.weight"].shape == (1, 10)
    for loaded in (jpt.load_reference_checkpoint(path),
                   tpt.load_reference_checkpoint(path)):
        assert sorted(loaded) == sorted(params)
        for k in params:
            for f in params[k]:
                np.testing.assert_array_equal(loaded[k][f], params[k][f])
    path = str(tmp_path / "jax.pt")
    jpt.save_reference_checkpoint(path, params)
    loaded = tpt.load_reference_checkpoint(path)
    for k in params:
        for f in params[k]:
            np.testing.assert_array_equal(loaded[k][f], params[k][f])


def test_cli_evaluate_cpu(tmp_path, capsys):
    out = str(tmp_path / "ev")
    src = os.path.join(ARTIFACTS, "flagship_separable.npz")
    cli.main(["evaluate", src, "--device", "cpu", "--dtype", "float64",
              "--table-knots", "0", "--oracle", "wind", "--steps", "20",
              "--r-lo", "1.0", "--r-hi", "1.5", "--out", out])
    got = last_json(capsys)
    assert list(got) == EVALUATE_KEYS
    assert got["oracle"] == "wind" and got["checkpoint"] == src
    assert got["fit_rms_mHa"] < 0.01
    tree, meta = jckpt.load_params(os.path.join(out, "evaluated.npz"))
    assert meta == {"fit_rms": meta["fit_rms"], "table_knots": 0,
                    "target_state": "1ssg", "r_lo": 1.0, "r_hi": 1.5}
    assert sorted(tree) == ["params"]
    shipped = load_artifact("flagship_separable.npz")
    for k in shipped:
        for f in shipped[k]:
            same = np.array_equal(tree["params"][k][f], shipped[k][f])
            assert same == (k not in ("e1", "e2", "eout")), (k, f)
    with open(os.path.join(out, "energy_eval.pkl"), "rb") as f:
        surf = pickle.load(f)
    # the JAX package's R rule, whose float arange reaches past r_hi here
    np.testing.assert_array_equal(
        surf["R"], np.round(np.arange(1.0, 1.5 + 0.1, 0.1), 2))
    assert np.all(surf["Elcao"] == 0.0)


def test_cli_evaluate_table_and_distill(tmp_path, capsys):
    """With a spline table: the e_table subtree, the tab_* keys (the
    off-knot points against the ODE oracle). cli distill writes the E head
    and its fit RMS."""
    src = os.path.join(ARTIFACTS, "flagship_separable.npz")
    out = str(tmp_path / "ev")
    cli.main(["evaluate", src, "--device", "cpu", "--dtype", "float64",
              "--table-knots", "6", "--oracle", "wind", "--steps", "0",
              "--r-lo", "1.0", "--r-hi", "1.5", "--out", out])
    got = last_json(capsys)
    assert list(got) == EVALUATE_KEYS + TABLE_KEYS
    assert got["tab_max_err_mHa"] < 0.05
    tree, meta = jckpt.load_params(os.path.join(out, "evaluated.npz"))
    assert meta["table_knots"] == 6 and len(tree["e_table"]["R"]) == 6
    dst = str(tmp_path / "d.npz")
    cli.main(["distill", src, "--device", "cpu", "--dtype", "float64",
              "--steps", "10", "--r-lo", "1.0", "--r-hi", "1.2", "--out",
              dst])
    got = last_json(capsys)
    assert list(got) == ["out", "fit_rms_mHa"] and got["out"] == dst
    tree, meta = jckpt.load_params(dst)
    assert list(meta) == ["fit_rms"]
    assert round(1e3 * meta["fit_rms"], 4) == got["fit_rms_mHa"]


def test_cli_scoring_refuses_what_is_not_ported(tmp_path):
    npz = str(tmp_path / "m.npz")
    jckpt.save(npz, {"params": ref_params()}, meta={})
    base = ["--device", "cpu", "--n-test", "8", "--r-lo", "1.0", "--r-hi",
            "1.0"]
    with pytest.raises(SystemExit, match="minimal family"):
        cli.main(["energy", str(tmp_path / "m.bin")] + base)
    with pytest.raises(SystemExit, match="ROADMAP"):
        cli.main(["energy", npz, "--figure", str(tmp_path / "s.pdf")] + base)
    with pytest.raises(SystemExit, match="deflation"):
        cli.main(["evaluate", npz, "--contam-vs", npz] + base)
    # a pi-sector checkpoint (m_abs in its meta) raises through the ansatz
    with pytest.raises(NotImplementedError, match="m_abs"):
        cli.main(["evaluate", os.path.join(ARTIFACTS, "pi_2ppu.npz"),
                  "--table-knots", "0"] + base)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["energy", npz, "--out", str(tmp_path / "e.pkl")])
