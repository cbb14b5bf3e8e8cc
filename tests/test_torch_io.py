"""Checkpoints, the CLI and the import boundary of the PyTorch port.

A port checkpoint loads in the JAX package's reader and gives the same psi
in the JAX ansatz (float64, rtol 1e-12); the port imports nothing of JAX,
optax or the JAX package."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.io import checkpoint as jckpt
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
import pinn_for_quantum_wavefunction_surfaces_tpu_torch as port
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import cli
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import \
    checkpoint as tckpt
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans

from test_torch_separable import (ARTIFACTS, jax_model,  # noqa: F401
                                  no_jax_cache_writes, points)

PORT_DIR = os.path.dirname(port.__file__)
REPO = os.path.dirname(PORT_DIR)
FORBIDDEN = ("jax", "jaxlib", "optax", "pinn_for_quantum_wavefunction_surfaces_tpu")


def assert_same_psi(np_params, p_sym=1):
    mcfg = pqs.ModelConfig(arch="separable", inversion_symmetry=p_sym)
    x, y, z, r = points(n=300, seed=9)
    want, _ = jans.psi(np_params, mcfg, x, y, z, r)
    tm = port.ModelConfig(arch="separable", inversion_symmetry=p_sym)
    tp = tans.from_jax_params(np_params, device="cpu")
    got, _ = tans.psi(tp, tm, *(torch.as_tensor(a) for a in (x, y, z, r)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-14)


def test_port_checkpoint_loads_in_jax_reader(tmp_path):
    _, _, params = jax_model()
    tp = tans.from_jax_params(params, device="cpu")
    path = str(tmp_path / "port.npz")
    tckpt.save(path, {"params": tp}, meta={"polish": "spheroidal-lbfgs"})
    loaded, meta = jckpt.load_params(path)
    assert meta == {"polish": "spheroidal-lbfgs"}
    assert jckpt.load_meta(path) == tckpt.load_meta(path)
    for k in params:
        for f in params[k]:
            np.testing.assert_array_equal(loaded["params"][k][f],
                                          params[k][f])
    assert_same_psi(loaded["params"])


def test_jax_checkpoint_loads_in_port_reader(tmp_path):
    path = str(tmp_path / "jax.npz")
    _, _, params = jax_model()
    jckpt.save(path, {"params": params}, meta={"fit_rms": 1e-6})
    loaded, meta = tckpt.load_params(path)
    assert meta == {"fit_rms": 1e-6}
    for k in params:
        for f in params[k]:
            np.testing.assert_array_equal(loaded["params"][k][f],
                                          params[k][f])
    shipped, _ = tckpt.load_params(os.path.join(ARTIFACTS,
                                                "flagship_separable.npz"))
    assert sorted(shipped["params"]) == sorted(
        jckpt.load_params(os.path.join(ARTIFACTS,
                                       "flagship_separable.npz"))[0]["params"])


def test_cli_variational_cpu_run_loads_in_jax(tmp_path, capsys):
    out = str(tmp_path / "run")
    cli.main(["variational", "--arch", "separable", "--spheroidal",
              "--adam-warmup", "3", "--lbfgs", "2", "--n-r", "2",
              "--n-xi", "8", "--n-eta", "6", "--dtype", "float64",
              "--hidden", "4", "--xi-span", "25", "--device", "cpu",
              "--out", out])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["polish"] == "spheroidal-lbfgs"
    assert summary["lbfgs_steps"] == 2 and summary["device"] == "cpu"
    path = os.path.join(out, "variational.npz")
    params, meta = jckpt.load_params(path)
    assert meta == {"polish": "spheroidal-lbfgs", "xi_span": 25.0}
    assert jckpt.load_meta(os.path.join(out, "warmup.npz")) == {
        "polish": "spheroidal-adam-warmup"}
    params = params["params"]
    assert params["lam2"]["w"].shape == (4, 4)
    assert_same_psi(params)


def test_cli_refuses_what_is_not_ported(tmp_path):
    base = ["variational", "--out", str(tmp_path), "--device", "cpu",
            "--lbfgs", "1"]
    with pytest.raises(SystemExit, match="separable"):
        cli.main(base + ["--spheroidal"])
    with pytest.raises(SystemExit, match="spheroidal"):
        cli.main(base + ["--arch", "separable"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["variational", "--arch", "separable", "--spheroidal",
                      "--lbfgs", "1", "--out", str(tmp_path)])


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_sources_import_no_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT_DIR)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 10
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_roots(f) if _forbidden(m)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    port = "pinn_for_quantum_wavefunction_surfaces_tpu_torch"
    modules = ["cli", "training.variational", "analysis.energy",
               "training.engine", "utils.metrics", "analysis.etab",
               "training.distill", "ops.pallas_residual", "ops.quadrature",
               "io.torch_pt"]
    code = (f"import sys, {port}, "
            + ", ".join(f"{port}.{m}" for m in modules)
            + "; print('\\n'.join(sys.modules))")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO, env=env).stdout
    bad = [m for m in out.split() if _forbidden(m)]
    assert not bad, bad
