"""The analysis subcommands of the port's CLI (analyze, vibrations, export,
energy --figure) and ``train --profile`` on the CPU at the smoke sizes
(``--device cpu --n-test 8 --hf-points 2``; the probes' cubes stay at the
default 80^3, as in the JAX CLI, whose ``analyze`` reads no n for them).

``vibrations`` prints the JAX CLI's JSON lines on the same artifacts (and
the rovib goldens' levels to 2e-9 Ha); ``export`` writes .bin and .csv
files byte-identical to the JAX CLI's, .pt files both packages' loaders
read back to the same arrays, and .npz archives both read back bit for
bit; ``analyze`` writes the JAX CLI's figure names, and fails before any
work on a host without matplotlib or, without ``--device cpu``, without
CUDA."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from pinn_for_quantum_wavefunction_surfaces_tpu import cli as jcli
from pinn_for_quantum_wavefunction_surfaces_tpu.io import checkpoint as jckpt
from pinn_for_quantum_wavefunction_surfaces_tpu.io import modelbin as jbin
from pinn_for_quantum_wavefunction_surfaces_tpu.io import torch_pt as jpt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import cli
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    etab as tetab
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    plots as tplots
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
    checkpoint as tckpt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
    modelbin as tbin
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
    torch_pt as tpt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.utils.metrics import \
    save_history

from test_torch_excited import one_torch_thread  # noqa: F401
from test_torch_separable import (ARTIFACTS, no_jax_cache_writes,  # noqa: F401
                                  load_artifact)

SMOKE = ["--device", "cpu", "--n-test", "8", "--hf-points", "2"]
HISTORY = {"Ltot": np.array([3.0, 2.0, 1.0]), "Lpde": np.array([2.0, 1.5, 0.8]),
           "Lbc": np.array([1.0, 0.5, 0.2]),
           "Energy": np.array([-0.5, -0.55, -0.6])}


def art(name):
    return os.path.join(ARTIFACTS, name)


def json_lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_cli_analyze_paper_set(tmp_path, capsys):
    """--paper-set with --history writes every PAPER_SET_NAMES file, in the
    JAX CLI's order (a float64 separable checkpoint: its surface's model
    quotients are K1's on the card)."""
    hist = str(tmp_path / "history.pkl")
    save_history(hist, HISTORY)
    out = str(tmp_path / "figs")
    cli.main(["analyze", art("flagship_separable.npz"), "--out", out,
              "--paper-set", "--history", hist, "--grid", "uniform",
              "--dtype", "float64"] + SMOKE)
    got = json_lines(capsys)[-1]["figures"]
    assert [os.path.basename(p) for p in got] == [
        "fig2.pdf", "fig3.pdf", "fig4.pdf", "fig_R1.pdf", "fig_R2.pdf",
        "fig_R3.pdf", "energy.png", "R1.png", "R2.png", "R1e.png",
        "R2e.png", "loss_figure.pdf"]
    assert sorted(os.listdir(out)) == sorted(tplots.PAPER_SET_NAMES)
    assert all(os.path.getsize(p) > 0 for p in got)


def test_cli_analyze_figures(tmp_path, capsys):
    """Without --paper-set: the E head, gate, exponents, psi cuts, and with
    --forces and --history the force panel and the loss figure, under the
    JAX CLI's file names; the default --dtype scores in float32."""
    hist = str(tmp_path / "history.pkl")
    save_history(hist, HISTORY)
    out = str(tmp_path / "figs")
    cli.main(["analyze", art("flagship.npz"), "--out", out, "--forces",
              "--history", hist, "--r-cuts", "1.5"] + SMOKE)
    got = [os.path.basename(p) for p in json_lines(capsys)[-1]["figures"]]
    assert got == ["energy.png", "gate.pdf", "exponents.pdf", "R1.5.png",
                   "R1.5e.png", "forces.pdf", "loss_figure.jpg"]
    assert sorted(os.listdir(out)) == sorted(got)


def test_cli_analyze_refuses_before_any_work(tmp_path, monkeypatch):
    """No CUDA: without --device cpu the port's analyze raises on this host
    (nothing falls back). No matplotlib: analyze and energy --figure fail
    naming the package, before any file is written."""
    out = tmp_path / "figs"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["analyze", art("flagship.npz"), "--out", str(out)])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(tplots.MatplotlibMissing, match="matplotlib"):
        cli.main(["analyze", art("flagship.npz"), "--out", str(out),
                  "--paper-set"] + SMOKE)
    pkl = tmp_path / "e.pkl"
    with pytest.raises(tplots.MatplotlibMissing, match="matplotlib"):
        cli.main(["energy", art("flagship.npz"), "--out", str(pkl),
                  "--figure", str(tmp_path / "s.pdf"), "--device", "cpu",
                  "--n-test", "8"])
    assert not out.exists() and not pkl.exists()


def test_cli_energy_figure(tmp_path, capsys):
    """energy --figure writes the surface figure after the JAX CLI's JSON
    line and prints its path last."""
    fig = str(tmp_path / "surface.pdf")
    cli.main(["energy", art("flagship.npz"), "--out", str(tmp_path / "e.pkl"),
              "--figure", fig, "--device", "cpu", "--n-test", "8",
              "--r-lo", "1.0", "--r-hi", "1.3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert sorted(json.loads(lines[-2])) == ["max_err_mHa", "mean_err_mHa",
                                             "oracle", "surface"]
    assert lines[-1] == fig and os.path.getsize(fig) > 0


VIBRATIONS = [
    (art("evaluated.npz"), ["--j-max", "5"]),
    (art("pi_2ppu_well.npz"), ["--j-max", "5", "--n-levels", "3"]),
    (art("excited_3dsg_well.npz"), ["--j-max", "5"]),
    (art("evaluated.npz"), []),
    (art("excited_2ssg.npz"), ["--j", "2", "--n-levels", "2"]),
]


@pytest.mark.parametrize("source,flags", VIBRATIONS,
                         ids=["1ssg-grid", "2ppu-grid", "3dsg-grid",
                              "1ssg-ladder", "2ssg-j2"])
def test_cli_vibrations_matches_jax(source, flags, tmp_path, capsys):
    out = str(tmp_path / "rovib.json")
    extra = ["--out", out] if "--j-max" in flags else []
    jcli.main(["vibrations", source] + flags)
    want = json_lines(capsys)[-1]
    cli.main(["vibrations", source] + flags + extra)
    got = json_lines(capsys)[-1]
    assert got == want
    if extra:
        with open(out) as fh:
            assert json.load(fh) == got
    else:
        # the ladder's state comes from the artifact's meta
        assert got["state"] == tckpt.load_meta(source).get("target_state",
                                                           "1ssg")


@pytest.mark.parametrize("golden", ["rovib_1ssg.json",
                                    "rovib_2ppu_well.json",
                                    "rovib_3dsg_well.json"])
def test_cli_vibrations_reproduces_rovib_goldens(golden, capsys):
    with open(art(golden)) as fh:
        want = json.load(fh)
    cli.main(["vibrations", os.path.join(ARTIFACTS, "..", want["source"]),
              "--j-max", str(want["j_max"]), "--n-levels", str(want["n_v"]),
              "--state", want["state"]])
    got = json_lines(capsys)[-1]
    np.testing.assert_allclose(np.asarray(got["levels_Ha"]),
                               np.asarray(want["levels_Ha"]), rtol=0,
                               atol=2e-9)
    for key in ("state", "n_v", "j_max", "asymptote_Ha", "mu"):
        assert got[key] == want[key], key


def test_cli_vibrations_refusals():
    """The JAX CLI's exits: no artifact and no --oracle; an artifact
    without an e_table."""
    with pytest.raises(SystemExit, match="give an evaluated"):
        cli.main(["vibrations"])
    with pytest.raises(SystemExit, match="no e_table"):
        cli.main(["vibrations", art("flagship.npz")])


def _same_tree(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert sorted(a[k]) == sorted(b[k])
        for f in a[k]:
            assert np.asarray(a[k][f]).dtype == np.asarray(b[k][f]).dtype
            np.testing.assert_array_equal(a[k][f], b[k][f])


@pytest.mark.parametrize("src", ["flagship_model.bin", "flagship.npz",
                                 "flagship.pt"])
def test_cli_export_matches_jax(src, tmp_path, capsys):
    """.bin bytes equal to the JAX CLI's; the .pt read by both loaders; the
    .npz read back bit for bit (the checkpoint's own arrays: no cast)."""
    if src == "flagship.pt":
        path = str(tmp_path / src)
        jpt.save_reference_checkpoint(path, jbin.load_params(
            art("flagship_model.bin")))
    else:
        path = art(src)
    for ext in ("bin", "pt", "npz"):
        j_out, t_out = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
        jcli.main(["export", path, j_out])
        cli.main(["export", path, t_out])
        lines = json_lines(capsys)
        assert lines[-1] == {"written": t_out}
        assert lines[-2] == {"written": j_out}
        if ext == "bin":
            with open(j_out, "rb") as fj, open(t_out, "rb") as ft:
                assert fj.read() == ft.read()
            _same_tree(tbin.load_params(t_out), jbin.load_params(j_out))
        elif ext == "pt":
            _same_tree(tpt.load_reference_checkpoint(t_out),
                       jpt.load_reference_checkpoint(j_out))
            _same_tree(jpt.load_reference_checkpoint(t_out),
                       jpt.load_reference_checkpoint(j_out))
        else:
            want = cli._load_params(path)
            _same_tree(tckpt.load_params(t_out)[0]["params"], want)
            _same_tree(jckpt.load_params(t_out)[0]["params"], want)


def test_cli_export_table_csv_and_refusals(tmp_path, capsys):
    """The E(R) table as .csv, byte-identical to the JAX CLI's (153 rows,
    the knots of etab.load_table); the separable family has no .bin / .pt
    form (the reference's formats hold the symmetric tree), and an artifact
    without an e_table has no .csv."""
    j_out, t_out = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jcli.main(["export", art("evaluated.npz"), j_out])
    cli.main(["export", art("evaluated.npz"), t_out])
    assert json_lines(capsys)[-1] == {"written": t_out, "knots": 153}
    with open(j_out, "rb") as fj, open(t_out, "rb") as ft:
        assert fj.read() == ft.read()
    rows = np.loadtxt(t_out, delimiter=",", skiprows=1)
    table = tetab.load_table(art("evaluated.npz"))
    assert rows.shape == (153, 3)
    np.testing.assert_allclose(rows[:, 0], table["R"], rtol=1e-11)
    np.testing.assert_allclose(rows[:, 1], table["E"], rtol=1e-14)
    for ext in ("bin", "pt"):
        with pytest.raises(SystemExit, match="lacks its layers"):
            cli.main(["export", art("flagship_separable.npz"),
                      str(tmp_path / f"s.{ext}")])
    with pytest.raises(SystemExit, match="no e_table"):
        cli.main(["export", art("flagship.npz"), str(tmp_path / "x.csv")])


def test_cli_train_profile(tmp_path, capsys):
    """train --profile DIR writes a Chrome trace of the run into DIR, with
    the trainer's spans, and each chunk's record in metrics.jsonl carries
    the last step's phase ms."""
    prof = tmp_path / "prof"
    cli.main(["train", "--device", "cpu", "--epochs", "2", "--n-train", "64",
              "--out", str(tmp_path / "run"), "--profile", str(prof)])
    assert sorted(json_lines(capsys)[-1]) == ["best_loss", "points_per_sec",
                                              "runtime_s"]
    with open(prof / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert {"pinn.advance", "pinn.resample", "pinn.step",
            "pinn.read"} <= names
    assert os.path.exists(tmp_path / "run" / "best.npz")
    with open(tmp_path / "run" / "metrics.jsonl") as fh:
        recs = [json.loads(line) for line in fh]
    assert recs and all(
        {"forward_ms", "backward_ms", "update_ms"} <= set(r) for r in recs)
