"""The per-R sweep (training/sweep.py, ``cli sweep``), the residual
parser's sector flags and ``--mesh`` on the CLI, against the JAX package.

tests/test_sweep.py's three cases in the port; the vmapped family against
the JAX package's ``train_per_r_vmapped`` from the per-model initial
states its ``init_one`` draws (carried across, ``resample_frac = 0`` so
that no batch is redrawn), in this process and with the models split over
two gloo ranks (one job for the module, tests/torch_rank_jobs.py): loss
history, best losses and E heads rtol 1e-8 (float64; the JAX tests' rtol
for training). ``cli train``, ``finetune`` and ``sweep`` take the JAX
CLI's --m-abs, --wide-alpha, --xi-span and --r-cluster; ``cli sweep
--help`` lists the JAX CLI's flags but for the JAX-only --kernel and
--remat and the port's --device; ``--mesh 1`` equals no mesh bit for bit
and ``--mesh 2`` (gloo) equals it to rtol 1e-12.
"""

import dataclasses
import json
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu import cli as jcli
from pinn_for_quantum_wavefunction_surfaces_tpu.analysis import energy as jen
from pinn_for_quantum_wavefunction_surfaces_tpu.io import checkpoint as jckpt
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
from pinn_for_quantum_wavefunction_surfaces_tpu.ops import sampling as jsam
from pinn_for_quantum_wavefunction_surfaces_tpu.training import \
    sweep as jsweep
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import cli
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.parallel import \
    mesh as pmesh
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    sweep as tsweep

import torch_rank_jobs
from test_torch_excited import one_torch_thread  # noqa: F401
from test_torch_sampling_losses import port_cfg
from test_torch_separable import no_jax_cache_writes  # noqa: F401

R_FAMILY = [0.8, 1.5, 2.5, 3.5]
JOB_TIMEOUT = 600


def jax_cfg(**train):
    cfg = pqs.smoke_config(dtype="float64")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, n_train=512, epochs=30, scan_chunk=15, **train))


def jax_init_states(cfg, r_values):
    """(params, batch) of each model as the JAX package's
    train_per_r_vmapped draws them (its init_one), in numpy."""
    dtype = jnp.dtype(cfg.dtype)
    keys = jax.random.split(jax.random.PRNGKey(cfg.train.seed),
                            len(r_values))
    out = []
    for key, ri in zip(keys, jnp.asarray(r_values, dtype)):
        kp, kb, _ = jax.random.split(key, 3)
        params = jans.init_params(kp, cfg.model, dtype)
        batch = jsam.sample_batch_at_r(kb, cfg, ri, n=cfg.train.n_train)
        out.append((jax.tree.map(np.asarray, params),
                    [np.asarray(a) for a in batch]))
    return out


@pytest.fixture(scope="module")
def family():
    """The frozen family's config and the JAX package's initial states."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    try:
        cfg = jax_cfg(resample_frac=0.0)
        return cfg, jax_init_states(cfg, R_FAMILY)
    finally:
        jax.config.update(key, old)


@pytest.fixture(scope="module")
def ranks(family):
    """The family with its models split over two gloo ranks."""
    cfg, init = family
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return pmesh.launch(
            torch_rank_jobs.sweep_job, 2, device="cpu",
            args=({"cfg": port_cfg(cfg), "r": R_FAMILY, "init": init},),
            timeout=JOB_TIMEOUT)
    finally:
        torch.set_num_threads(threads)


def test_sequential_sweep(one_torch_thread):  # noqa: F811
    out = tsweep.train_per_r(port_cfg(jax_cfg()), [1.0, 2.0], device="cpu")
    assert out["E_net"].shape == (2,)
    assert np.isfinite(out["E_net"]).all()
    assert len(out["params"]) == 2
    # deeper well at shorter bond: E(R=1) < E(R=2) electronically
    assert out["E_net"][0] < out["E_net"][1]


def test_vmapped_sweep_matches_shapes(one_torch_thread):  # noqa: F811
    """tests/test_sweep.py's case (resampling on) from the JAX package's
    per-model inits, whose property it is: the port's own seeded inits
    differ, and the third of them starts at a loss of 4.9e-6 (the others
    near 4e-2) that 30 steps of this smoke schedule do not get below."""
    cfg = jax_cfg()
    out = tsweep.train_per_r_vmapped(
        port_cfg(cfg), R_FAMILY, device="cpu",
        init=[(p, torch_rank_jobs.batch_of(b))
              for p, b in jax_init_states(cfg, R_FAMILY)])
    assert out["E_net"].shape == (4,)
    assert out["loss_history"].shape == (30, 4)
    assert np.isfinite(out["loss_history"]).all()
    # training reduced the loss for every member of the family
    assert (out["best_loss"] < out["loss_history"][0]).all()
    assert all(v.shape[0] == 4 for t in out["params"].values()
               for v in t.values())


def test_polish_sweep_hits_exact_per_r(one_torch_thread):  # noqa: F811
    """The per-R polish of the separable family lands each member within
    [-1e-4, 0.01] mHa of its exact eigenvalue."""
    cfg = tcfg.Config(dtype="float64",
                      model=tcfg.ModelConfig(arch="separable"))
    rs = [1.0, 2.0]
    out = tsweep.polish_per_r(cfg, rs, steps=80, n_xi=24, n_eta=16,
                              device="cpu")
    err = 1e3 * (out["E_net"] - jen.exact_energy_ode(np.asarray(rs)))
    assert (err >= -1e-4).all(), err
    assert (err <= 0.01).all(), err


def assert_family_matches(want, got):
    np.testing.assert_allclose(got["loss_history"],
                               np.asarray(want["loss_history"]), rtol=1e-8)
    np.testing.assert_allclose(got["best_loss"], want["best_loss"],
                               rtol=1e-8)
    np.testing.assert_allclose(got["E_net"], want["E_net"], rtol=1e-8)
    np.testing.assert_array_equal(got["R"], want["R"])


def test_vmapped_sweep_matches_jax(family, one_torch_thread):  # noqa: F811
    """From the JAX package's per-model states, the port's family (one
    model after another each step) equals the JAX package's vmapped
    family."""
    cfg, init = family
    want = jsweep.train_per_r_vmapped(cfg, R_FAMILY)
    got = tsweep.train_per_r_vmapped(
        port_cfg(cfg), R_FAMILY, device="cpu",
        init=[(p, torch_rank_jobs.batch_of(b)) for p, b in init])
    assert_family_matches(want, got)


def test_vmapped_sweep_on_two_ranks_matches_jax(family, ranks):
    """The models split over two ranks (two each): the same family, on
    both ranks."""
    cfg, _ = family
    assert_family_matches(jsweep.train_per_r_vmapped(cfg, R_FAMILY), ranks)
    assert ranks["same_on_ranks"]


def test_vmapped_sweep_refuses_an_uneven_split(ranks):
    """Three models on two ranks raise, as the JAX package's sharding of
    the model axis does (ValueError on its 8-device mesh for 3 or 5)."""
    assert ranks["uneven"] is not None
    assert "3 models do not split evenly over 2 ranks" in ranks["uneven"]


def _help_flags(main, sub, capsys) -> set:
    with pytest.raises(SystemExit):
        main([sub, "--help"])
    text = capsys.readouterr().out
    return set(re.findall(r"(?<![\w-])(--[a-z][a-z0-9-]*)", text))


# the flags of a port subcommand that its JAX counterpart lacks, and why:
# every device-running subcommand takes --device; the scoring subcommands
# take --arch (a model.bin or .npz of the minimal family scores as that
# family); bench takes the root bench.py's flags (the JAX CLI's bench
# takes --n only)
PORT_ONLY_FLAGS = {
    "energy": {"--device", "--arch"}, "analyze": {"--device", "--arch"},
    "distill": {"--device", "--arch"}, "evaluate": {"--device", "--arch"},
    "export": set(), "vibrations": set(),
    "bench": {"--device", "--arch", "--dtype", "--steps", "--repeats",
              "--no-baseline"},
}


def _dtype_choices(main, sub, capsys) -> list:
    with pytest.raises(SystemExit):
        main([sub, "--help"])
    return re.findall(r"--dtype \{([^}]*)\}", capsys.readouterr().out)


@pytest.mark.parametrize("sub", ["sweep", "train", "finetune", "variational",
                                 "energy", "analyze", "distill", "evaluate",
                                 "export", "vibrations", "bench"])
def test_cli_parsers_list_the_jax_flags(sub, capsys):
    """Every port subcommand lists its JAX counterpart's flags but for the
    XLA switches (--kernel, --remat), with the port's own flags of
    PORT_ONLY_FLAGS, and the same --dtype choices in the same order
    (float32, float64, bfloat16) wherever the JAX subcommand takes
    --dtype."""
    want = _help_flags(jcli.main, sub, capsys) - {"--kernel", "--remat"}
    got = _help_flags(cli.main, sub, capsys) - PORT_ONLY_FLAGS.get(
        sub, {"--device"})
    assert got == want, (sorted(got - want), sorted(want - got))
    want_dtypes = _dtype_choices(jcli.main, sub, capsys)
    if want_dtypes:
        assert _dtype_choices(cli.main, sub, capsys) == want_dtypes


def _train_both(tmp_path, capsys, sub, flags):
    """Run ``sub`` with ``flags`` through both CLIs: the JSON lines and the
    output directories."""
    outs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        out = str(tmp_path / name)
        main([sub] + flags + extra + ["--out", out])
        outs[name] = (json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]), out)
    return outs


def _layout(path):
    tree, meta = jckpt.load_params(path)
    tree = tree.get("params", tree)
    return {k: {f: (np.shape(a), np.asarray(a).dtype)
                for f, a in v.items()} for k, v in tree.items()}, meta


def test_cli_train_finetune_take_the_sector_flags(
        tmp_path, capsys, one_torch_thread):  # noqa: F811
    """A separable --m-abs 1 --wide-alpha model trains a few steps through
    both CLIs, with the same param layout (the wide-alpha heads) and meta
    keys; the port fine-tunes it with the same flags."""
    flags = ["--arch", "separable", "--m-abs", "1", "--wide-alpha",
             "--xi-span", "24", "--r-cluster", "log", "--epochs", "3",
             "--n-train", "64", "--dtype", "float64"]
    outs = _train_both(tmp_path, capsys, "train", flags)
    want, want_meta = _layout(os.path.join(outs["jax"][1], "best.npz"))
    got, got_meta = _layout(os.path.join(outs["port"][1], "best.npz"))
    assert got == want
    assert any(k.startswith("xalpha") for k in got)
    assert sorted(got_meta) == sorted(want_meta)
    assert sorted(outs["port"][0]) == sorted(outs["jax"][0])
    ft = str(tmp_path / "ft")
    cli.main(["finetune", os.path.join(outs["port"][1], "best.npz"),
              "--device", "cpu", "--out", ft] + flags)
    assert "best_loss" in json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    tuned, _ = _layout(os.path.join(ft, "finetune.npz"))
    assert tuned == got


def test_cli_sweep_writes_the_jax_files(tmp_path, capsys,
                                        one_torch_thread):  # noqa: F811
    """cli sweep (the family, and --polish) writes the JAX CLI's pickle
    keys and JSON line; --polish with --mesh exits as the JAX CLI does."""
    flags = ["--r-values", "1.0", "2.0", "--epochs", "3", "--n-train", "64",
             "--dtype", "float64", "--arch", "separable", "--m-abs", "1",
             "--wide-alpha"]
    outs = _train_both(tmp_path, capsys, "sweep", flags)
    for name in ("jax", "port"):
        line, out = outs[name]
        assert sorted(line) == ["E_net", "R", "out"]
        assert line["R"] == [1.0, 2.0]
        with open(out, "rb") as f:
            assert sorted(pickle.load(f)) == ["E_net", "R", "best_loss"]
    pol = str(tmp_path / "pol.pkl")
    cli.main(["sweep", "--r-values", "1.0", "--polish", "2", "--arch",
              "separable", "--dtype", "float64", "--device", "cpu", "--out",
              pol])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["R"] == [1.0] and np.isfinite(line["E_net"]).all()
    with pytest.raises(SystemExit, match="does not shard over a mesh"):
        cli.main(["sweep", "--polish", "2", "--mesh", "2", "--device", "cpu"])


def test_cli_mesh_runs_from_one_command_line(tmp_path, capfd):
    """cli train --mesh 1 equals the unsharded run bit for bit; --mesh 2
    (two gloo ranks spawned by the one command) equals it to rtol 1e-12
    and writes its files once; variational refuses --mesh where the JAX
    CLI does (--fixed-r) and off the spheroidal polish."""
    base = ["train", "--device", "cpu", "--epochs", "4", "--n-train", "128",
            "--dtype", "float64", "--hidden", "4"]
    hist = {}
    for mesh in ("0", "1", "2"):
        out = str(tmp_path / f"m{mesh}")
        cli.main(base + ["--mesh", mesh, "--out", out])
        # the ranks' output goes to the process's stdout (capfd)
        lines = capfd.readouterr().out.strip().splitlines()
        assert len([ln for ln in lines if ln.startswith("{")]) == 1
        with open(os.path.join(out, "history.pkl"), "rb") as f:
            hist[mesh] = pickle.load(f)["Ltot"]
    np.testing.assert_array_equal(hist["1"], hist["0"])
    np.testing.assert_allclose(hist["2"], hist["0"], rtol=1e-12)
    for flags, match in ((["--spheroidal", "--lbfgs", "1", "--fixed-r",
                           "1.0"], "only one R"),
                         (["--lbfgs", "1"], "on one device")):
        with pytest.raises(SystemExit, match=match):
            cli.main(["variational", "--device", "cpu", "--mesh", "2"]
                     + flags)
