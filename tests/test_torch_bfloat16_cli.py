"""``--dtype bfloat16`` through the port's CLI against the JAX CLI, on the
CPU at smoke sizes, and on two gloo ranks.

Every subcommand whose JAX counterpart takes ``--dtype bfloat16`` runs
under it in both packages: the same JSON keys; the same checkpoint leaf
names and shapes, each leaf 2 bytes wide (numpy writes a bfloat16 array as
raw 2-byte values, ``V2``) and holding the bits of the port's params; a
bfloat16 checkpoint refused on reading, as the JAX package cannot read its
own back either; ``energy`` (and ``analyze``) scoring bfloat16 as float32;
``evaluate``'s mean errors within 1 mHa of the JAX CLI's
(test_torch_bfloat16_variational.py holds variational, distill and
evaluate). The JAX CLI runs with x64 off, as it does from a shell under
``--dtype bfloat16``. torch runs on one thread."""

import json
import os
import pickle

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from pinn_for_quantum_wavefunction_surfaces_tpu import cli as jcli
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import cli
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
    checkpoint as tckpt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.parallel import \
    mesh as pmesh
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    engine as teng

import torch_rank_jobs
from test_torch_excited import one_torch_thread  # noqa: F401
from test_torch_separable import ARTIFACTS, no_jax_cache_writes  # noqa: F401

BF16 = ["--dtype", "bfloat16"]


def run_both(tmp_path, capsys, sub, flags, out_is_file=False, jax_too=True):
    """``sub flags`` through the JAX CLI (x64 off) and the port's
    (``--device cpu``): {name: (last JSON line, output path)}."""
    outs = {}
    runs = [("port", cli.main, ["--device", "cpu"])]
    if jax_too:
        runs.insert(0, ("jax", jcli.main, []))
    for name, main, extra in runs:
        out = str(tmp_path / (f"{name}.npz" if out_is_file else name))
        with jax.enable_x64(False):
            main([sub] + flags + BF16 + extra + ["--out", out])
        outs[name] = (json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]), out)
    return outs


def raw_leaves(path) -> dict:
    """{key: array} of a .npz as numpy reads it (no decoding)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def assert_bf16_checkpoints_alike(port_path, jax_path):
    """The same leaf names and shapes, every float leaf 2 bytes wide."""
    got, want = raw_leaves(port_path), raw_leaves(jax_path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if want[k].dtype.itemsize == 2:
            assert got[k].dtype == tckpt.BFLOAT16_BITS, k
        else:
            assert got[k].dtype == want[k].dtype, k


def assert_holds_bits(path, params, prefix="params"):
    """Each leaf of the checkpoint holds the bfloat16 bits of ``params``
    (port tensors or ``to_numpy_params`` arrays)."""
    raw = raw_leaves(path)
    for k in params:
        for f in params[k]:
            want = tckpt.as_numpy(params[k][f]).view(np.int16)
            np.testing.assert_array_equal(
                raw[f"{prefix}/{k}/{f}"].view(np.int16), want,
                err_msg=f"{k}/{f}")


TRAIN_FLAGS = ["--epochs", "3", "--n-train", "128", "--gz",
               "--trainable-exponent"]


def test_cli_train_bfloat16(tmp_path, capsys, monkeypatch,
                            one_torch_thread):  # noqa: F811
    """cli train --dtype bfloat16: the JAX CLI's keys and files; best.npz,
    final.npz and state.npz of 2-byte leaves (Adam's moments too) holding
    the bits of engine.train's params in the same configuration."""
    outs = run_both(tmp_path, capsys, "train", TRAIN_FLAGS)
    assert sorted(outs["port"][0]) == sorted(outs["jax"][0])
    port, jax_dir = outs["port"][1], outs["jax"][1]
    for name in ("best.npz", "final.npz", "state.npz"):
        assert_bf16_checkpoints_alike(os.path.join(port, name),
                                      os.path.join(jax_dir, name))
    args = cli_args(["train"] + TRAIN_FLAGS + BF16 + ["--device", "cpu"],
                    monkeypatch)
    res = teng.train(cli._build_cfg(args), device="cpu")
    assert_holds_bits(os.path.join(port, "best.npz"), res.best_params)
    assert_holds_bits(os.path.join(port, "final.npz"), res.params)
    assert res.best_loss == outs["port"][0]["best_loss"]
    with open(os.path.join(port, "history.pkl"), "rb") as f:
        hist = pickle.load(f)
    assert hist["Ltot"].dtype == np.float32 and len(hist["Ltot"]) == 3


def cli_args(argv, monkeypatch):
    """The namespace the port's CLI parses from a train command line."""
    got = {}
    monkeypatch.setattr(cli, "cmd_train", lambda a: got.setdefault("a", a))
    cli.main(argv)
    return got["a"]


def test_bfloat16_checkpoints_are_refused(tmp_path, capsys,
                                          one_torch_thread):  # noqa: F811
    """A JAX-written bfloat16 best.npz and state.npz: the JAX package stops
    on them (numpy has no cast from their 2-byte leaves), and the port
    refuses them with a message naming the leaf, in load_params, cli
    finetune, cli train --resume and cli energy; their meta still reads."""
    out = str(tmp_path / "jax")
    with jax.enable_x64(False):
        jcli.main(["train"] + TRAIN_FLAGS + BF16 + ["--out", out])
    capsys.readouterr()
    best, state = (os.path.join(out, n) for n in ("best.npz", "state.npz"))
    with pytest.raises(ValueError, match="No cast function available"):
        jcli.main(["finetune", best, "--epochs", "1", "--out",
                   str(tmp_path / "jft")] + BF16)
    for path in (best, state):
        with pytest.raises(ValueError, match=r"leaf '.*' is bfloat16.*"
                           "cannot be read back"):
            tckpt.load_params(path)
        assert tckpt.load_meta(path)         # the meta reads
    base = ["--device", "cpu"] + BF16
    with pytest.raises(ValueError, match="written by a --dtype bfloat16"):
        cli.main(["finetune", best, "--epochs", "1", "--out",
                  str(tmp_path / "ft")] + base)
    with pytest.raises(ValueError, match="written by a --dtype bfloat16"):
        cli.main(["train", "--resume", state, "--epochs", "4", "--out",
                  str(tmp_path / "re")] + base)
    with pytest.raises(ValueError, match="written by a --dtype bfloat16"):
        cli.main(["energy", best, "--n-test", "8", "--out",
                  str(tmp_path / "e.pkl"), "--device", "cpu"])


def test_cli_finetune_and_sweep_bfloat16(tmp_path, capsys,
                                         one_torch_thread):  # noqa: F811
    """cli finetune of a float64 artifact and cli sweep (the residual
    family and --polish) under --dtype bfloat16: the JAX CLI's keys and
    files, 2-byte leaves."""
    outs = run_both(tmp_path / "ft", capsys, "finetune",
                    [os.path.join(ARTIFACTS, "flagship.npz"), "--epochs",
                     "3", "--n-train", "128"])
    assert sorted(outs["port"][0]) == sorted(outs["jax"][0])
    assert_bf16_checkpoints_alike(
        os.path.join(outs["port"][1], "finetune.npz"),
        os.path.join(outs["jax"][1], "finetune.npz"))
    for flags in (["--epochs", "3", "--n-train", "128"],
                  ["--polish", "2", "--arch", "separable"]):
        outs = run_both(tmp_path / flags[0][2:], capsys, "sweep",
                        flags + ["--r-values", "1.0"], out_is_file=True)
        assert sorted(outs["port"][0]) == sorted(outs["jax"][0])
        got = pickle.load(open(outs["port"][1], "rb"))
        want = pickle.load(open(outs["jax"][1], "rb"))
        assert sorted(got) == sorted(want)
        assert np.isfinite(np.asarray(got["E_net"], np.float64)).all()


def test_cli_energy_bfloat16_scores_in_float32(tmp_path, capsys):
    """cli energy --dtype bfloat16 writes the port's --dtype float32
    pickle bit for bit, and the JAX CLI's bfloat16 one (which casts
    nothing: float32 without x64) to float32's tolerance (rtol 2e-6, as
    tests/test_torch_cli_scoring.py states)."""
    src = os.path.join(ARTIFACTS, "flagship.npz")
    flags = ["--n-test", "16", "--r-lo", "0.9", "--r-hi", "1.2"]
    pkl = {}
    for name, main, extra in (("bf16", cli.main, BF16 + ["--device", "cpu"]),
                              ("f32", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, BF16)):
        pkl[name] = str(tmp_path / f"{name}.pkl")
        with jax.enable_x64(False):
            main(["energy", src, "--out", pkl[name]] + flags + extra)
    capsys.readouterr()
    with open(pkl["bf16"], "rb") as a, open(pkl["f32"], "rb") as b:
        assert a.read() == b.read()
    got, want = (pickle.load(open(pkl[k], "rb")) for k in ("bf16", "jax"))
    for k in ("E_int", "Elcao", "E_net"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-6, atol=0,
                                   err_msg=k)


def test_mesh_2_bfloat16_ranks_agree(one_torch_thread):  # noqa: F811
    """engine.train and the spheroidal polish under --mesh 2 (gloo) in
    bfloat16: finite, and the two ranks' params equal bit for bit."""
    out = pmesh.launch(torch_rank_jobs.bfloat16_job, 2, device="cpu",
                       timeout=300)
    assert out["train_same_on_ranks"] and out["polish_same_on_ranks"]
    assert np.isfinite(out["train_Ltot"]).all()
    assert out["train_Ltot"].dtype == np.float32
    assert out["polish_dtype"] == "torch.bfloat16"


def test_bfloat16_leaf_bits_round_trip():
    """to_numpy_params writes a bfloat16 leaf as its 2-byte bits, and
    from_jax_params reads such an in-memory array back exactly (a
    checkpoint's are refused before they get there)."""
    x = torch.tensor([1.0, -2.5, 3.0e-3, 7.0e4]).to(torch.bfloat16)
    a = tckpt.as_numpy(x)
    assert a.dtype == tckpt.BFLOAT16_BITS
    np.testing.assert_array_equal(a.view(np.int16), x.view(torch.int16))
    np.testing.assert_array_equal(
        a.view(np.int16), np.asarray(x.float().numpy(),
                                     ml_dtypes.bfloat16).view(np.int16))
    back = tans.from_jax_params({"e1": {"w": a}}, device="cpu")["e1"]["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)
