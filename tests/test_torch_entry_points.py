"""The port's remaining entry points against the JAX package's: the graft
entry (``graft_entry``: ``entry``, ``dryrun_multichip``) and the
``benchmarks`` scripts ``ref_recipe_score``, ``dispersion``, ``spectrum``
and ``scaling``, on the CPU at smoke sizes. The JAX scripts are imported
from the repo's root and run as they are (``__graft_entry__``,
``benchmarks/ref_recipe_score.py``, ``benchmarks/spectrum.py``), their
inputs pointed at temporary files.

- ``entry()``'s loss on the JAX entry's params and batch equals JAX's
  ``(l, l_pde, l_bc)`` to rtol 1e-5 (float32);
- ``dryrun_multichip(2)`` passes on two gloo ranks, which start once for
  the module and also run a row of ``scaling`` (tests/torch_rank_jobs.py);
- the float32 polish on one device moves past the dry run's tolerance when
  only the order of its sums changes, the float64 one does not (why the
  dry run's polish is float64);
- ``ref_recipe_score`` prints the JAX script's numbers to 1e-9 mHa;
- ``dispersion`` writes a pickle of the JAX script's structure;
- ``spectrum`` draws what the JAX script draws and notes the same missing
  states;
- every new entry point raises without CUDA unless given the CPU, and no
  module of the port imports JAX or the JAX package.
"""

import ast
import importlib.util
import json
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jgraft
import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import graft_entry
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    energy as ten
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.benchmarks import (
    dispersion, ref_recipe_score, scaling, spectrum)
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.io import checkpoint
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import ansatz
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.parallel import \
    mesh as pmesh

import torch_rank_jobs
from test_torch_excited import one_torch_thread  # noqa: F401
from test_torch_separable import no_jax_cache_writes  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "pinn_for_quantum_wavefunction_surfaces_tpu_torch")
RANKS = 2
JOB_TIMEOUT = 600
SCALING = dict(n=512, steps=2, quad_n=16)
# benchmarks/dispersion.py's family labels
JAX_FAMILIES = ["separable family (per-R optima)",
                "GZ + gate*NN family (per-R optima)"]


def jax_script(name: str):
    """A script of the repo's benchmarks/ directory, imported as it is."""
    spec = importlib.util.spec_from_file_location(
        f"jax_benchmarks_{name}", os.path.join(ROOT, "benchmarks",
                                               f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ranks():
    """The dry run and a scaling row, run once on two gloo ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return pmesh.launch(torch_rank_jobs.entry_points_job, RANKS,
                            device="cpu", args=({"scaling": SCALING},),
                            timeout=JOB_TIMEOUT)
    finally:
        torch.set_num_threads(threads)


def test_entry_matches_jax():
    """The port's fn on the JAX entry's params and batch: JAX's (l, l_pde,
    l_bc) to rtol 1e-5 in float32."""
    jfn, (jparams, jbatch) = jgraft.entry()
    want = [float(v) for v in jax.jit(jfn)(jparams, jbatch)]
    fn, (params, batch) = graft_entry.entry("cpu")
    assert params["lam1"]["w"].dtype == torch.float32
    assert batch.x.shape == (graft_entry.ENTRY_POINTS,)
    p = ansatz.from_jax_params(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    b = type(batch)(*(torch.as_tensor(np.array(a)) for a in jbatch))
    got = [float(v) for v in fn(p, b)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert all(np.isfinite([float(v) for v in fn(params, batch)]))


def test_graft_entry_main_prints_like_jax(capsys):
    graft_entry.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("entry OK: [")
    assert len(json.loads(out.split(":", 1)[1])) == 3


def test_dryrun_multichip_on_two_ranks(ranks):
    """The sharded step and polish on two gloo ranks hold to the JAX dry
    run's tolerances (its own checks raise otherwise)."""
    d = ranks["dryrun"]
    assert d["ranks"] == RANKS
    assert d["loss_single"] > 0
    assert abs(d["loss_sharded"] - d["loss_single"]) <= \
        1e-5 * d["loss_single"]
    assert d["polish_params_max_abs_diff"] <= 1e-7


def test_the_float32_polish_follows_the_order_of_its_sums(monkeypatch,
                                                          capsys):
    """Why the dry run's polish runs in float64: at the separable init the
    quotient does not change with the scale of psi, so the gradient of
    ``lamout.b`` and ``muout.b`` is zero but for roundoff, which in float32
    is near Adam's eps and sets their steps. One device, the dry run's
    polish (n_r 2, 8 x 6, 3 Adam steps), and the same with the points of
    every quadrature row reversed: in float32 the reversal alone moves
    those biases past the dry run's rtol 1e-5 / atol 1e-7; in float64 it
    moves no leaf past it. Prints the readings."""
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        variational

    base = variational.dual_grid_vbatch

    def reversed_rows(*args, **kw):
        vb = base(*args, **kw)
        return variational.VBatch(*(a.flip(-1) if a.ndim > 1 else a
                                    for a in vb))

    readings = {}
    for dt in ("float32", "float64"):
        cfg = config.Config(dtype=dt,
                            model=config.ModelConfig(arch="separable"))
        p0 = ansatz.init_params(cfg.model, seed=1, dtype=getattr(torch, dt),
                                device="cpu")
        # the scale direction's gradient at the init against the largest
        leaves = {k: {f: t.clone().requires_grad_(True)
                      for f, t in v.items()} for k, v in p0.items()}
        vb = base(cfg, 2, 8, 6, dtype=getattr(torch, dt), device="cpu")
        variational.quotient_loss(leaves, cfg, vb)[0].backward()
        grads = {f"{k}.{f}": float(t.grad.abs().max())
                 for k, v in leaves.items() for f, t in v.items()
                 if t.grad is not None}
        kw = dict(n_r=2, n_xi=8, n_eta=6, steps=0, adam_steps=3,
                  device="cpu")
        plain = variational.polish_spheroidal(p0, cfg, **kw)
        with monkeypatch.context() as m:
            m.setattr(variational, "dual_grid_vbatch", reversed_rows)
            rev = variational.polish_spheroidal(p0, cfg, **kw)
        readings[dt] = {
            "grad_lamout_b": grads["lamout.b"],
            "grad_largest": max(grads.values()),
            "moved_max_abs": max(float((rev[k][f] - plain[k][f]).abs().max())
                                 for k in plain for f in plain[k]),
            "moved_past_rtol_1e-5": sorted(
                f"{k}.{f}" for k in plain for f in plain[k]
                if not torch.allclose(rev[k][f], plain[k][f], rtol=1e-5,
                                      atol=1e-7))}
    with capsys.disabled():
        print(f"\nfloat32 polish, sums reversed: {json.dumps(readings)}")
    assert {"lamout.b", "muout.b"} <= set(
        readings["float32"]["moved_past_rtol_1e-5"])
    assert readings["float64"]["moved_past_rtol_1e-5"] == []
    assert readings["float32"]["grad_lamout_b"] < \
        1e-5 * readings["float32"]["grad_largest"]


def test_dryrun_multichip_on_one_rank():
    d = graft_entry.dryrun_multichip(1, device="cpu")
    assert d["ranks"] == 1
    # one rank sums as one device: bit for bit
    assert d["loss_sharded"] == d["loss_single"]
    assert d["step_params_max_abs_diff"] == 0.0
    assert d["polish_params_max_abs_diff"] == 0.0


def test_scaling_rows_and_quadrature(ranks, capsys):
    """One rank in this process, two on the module's ranks: the rows'
    keys (the port's two sharded paths), positive rates, and the sharded
    quadrature's E_int equal to the unsharded quotient."""
    out = scaling.main(counts=(1,), device="cpu", **SCALING)
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert lines == out["rows"] + [out["quadrature"]]
    rows = out["rows"] + [ranks["scaling"]["row"]]
    assert [r["devices"] for r in rows] == [1, 2]
    for row in rows:
        assert sorted(row) == ["devices", "engine_train_points_per_sec",
                               "shardmap_step_points_per_sec"]
        assert row["engine_train_points_per_sec"] > 0
        assert row["shardmap_step_points_per_sec"] > 0
    cfg = scaling.Config(dtype="float32")
    params = ansatz.init_params(cfg.model, seed=0, dtype=torch.float32,
                                device="cpu")
    want = ten.rayleigh_quotient(params, cfg, 1.0, n=SCALING["quad_n"])
    for quad in (out["quadrature"], ranks["scaling"]["quadrature"]):
        assert sorted(quad) == ["E_int", "points", "seconds",
                                "sharded_quadrature_n"]
        assert quad["points"] == SCALING["quad_n"] ** 3
        np.testing.assert_allclose(quad["E_int"], want, rtol=1e-6)


def test_ref_recipe_score_prints_the_jax_numbers(tmp_path, monkeypatch,
                                                 capsys):
    """One reference-parity checkpoint: the port's scores equal the JAX
    script's to 1e-9 mHa (the JAX script's print unrounded), and the
    printed lines have its keys and rounding."""
    cfg = pqs.Config(dtype="float64")
    params = jax.tree.map(np.asarray, jans.init_params(
        jax.random.PRNGKey(3), cfg.model, jnp.float64))
    path = tmp_path / "s3" / "stage2" / "finetune.npz"
    path.parent.mkdir(parents=True)
    checkpoint.save(str(path), {"params": params}, meta={})
    rows = ref_recipe_score.main(root=str(tmp_path), device="cpu")
    printed = [json.loads(ln) for ln in
               capsys.readouterr().out.strip().splitlines()]
    assert [r["run"] for r in rows] == ["s3/stage2/finetune.npz"]

    mod = jax_script("ref_recipe_score")
    monkeypatch.setattr(mod, "glob", types.SimpleNamespace(
        glob=lambda pattern: [str(path)]))
    monkeypatch.setattr(mod, "round", lambda v, nd=None: v, raising=False)
    mod.main()
    want = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert len(want) == 1
    assert sorted(want[0]) == sorted(rows[0]) == sorted(printed[0])
    for key, val in want[0].items():
        if key != "run":
            assert abs(rows[0][key] - val) <= 1e-9, key
            assert printed[0][key] == round(rows[0][key], 3)


def test_dispersion_writes_the_jax_structure(tmp_path, capsys):
    """2 R, 8 x 6, 3 steps: the pickle holds {label: {R, E_net,
    best_loss}} under the JAX script's labels; a gap line a family; the
    figure under the output directory."""
    rs = [1.0, 2.0]
    out = dispersion.main(r_values=rs, steps=3, n_xi=8, n_eta=6,
                          out_dir=str(tmp_path), device="cpu")
    with open(tmp_path / "dispersion.pkl", "rb") as f:
        pkl = pickle.load(f)
    assert list(pkl) == list(out) == JAX_FAMILIES
    for label, fam in pkl.items():
        assert sorted(fam) == ["E_net", "R", "best_loss"]
        np.testing.assert_array_equal(fam["R"], rs)
        assert fam["R"].dtype == np.float64
        assert fam["E_net"].shape == (2,) and np.all(
            np.isfinite(fam["E_net"]))
        np.testing.assert_array_equal(fam["best_loss"], fam["E_net"])
    lines = capsys.readouterr().out.strip().splitlines()
    gaps = [json.loads(ln) for ln in lines if ln.startswith('{"family"')]
    assert [g["family"] for g in gaps] == JAX_FAMILIES
    for g in gaps:
        assert sorted(g) == ["family", "max_gap_mHa", "mean_gap_mHa",
                             "min_signed_mHa"]
    assert json.loads(lines[-1]) == {"figure": str(tmp_path /
                                                   "dispersion.pdf")}
    assert (tmp_path / "dispersion.pdf").stat().st_size > 0


def test_spectrum_draws_or_notes_like_jax(tmp_path, monkeypatch, capsys):
    """Two surfaces and the rest missing: both scripts note the same
    states and draw a figure."""
    rs = np.array([1.0, 2.0, 3.0])
    sources = {}
    for state in spectrum.SOURCES:
        sources[state] = [str(tmp_path / f"{state}.pkl")]
        if state in ("1ssg", "2psu"):
            e = ten.exact_energy_ode(rs, state=state) + 1e-5
            with open(tmp_path / f"{state}.pkl", "wb") as f:
                pickle.dump({"R": rs, "E_int": e, "E_net": e}, f)
    got = spectrum.main(str(tmp_path / "port.pdf"), sources=sources)
    port_out = capsys.readouterr().out.strip().splitlines()
    mod = jax_script("spectrum")
    monkeypatch.setattr(mod, "SOURCES", sources)
    monkeypatch.setattr(sys, "argv", ["spectrum.py",
                                      str(tmp_path / "jax.pdf")])
    mod.main()
    jax_out = capsys.readouterr().out.strip().splitlines()
    assert port_out[:-1] == jax_out[:-1]
    assert len(port_out) == 1 + len(spectrum.SOURCES) - 2
    assert got == port_out[-1] == str(tmp_path / "port.pdf")
    assert os.path.getsize(got) > 0
    with pytest.raises(SystemExit, match="no surfaces"):
        spectrum.main(str(tmp_path / "none.pdf"),
                      sources={"1ssg": [str(tmp_path / "missing.pkl")]})


@pytest.mark.parametrize("call", [
    lambda tmp: graft_entry.entry(),
    lambda tmp: graft_entry.dryrun_multichip(1),
    lambda tmp: ref_recipe_score.main(root=str(tmp)),
    lambda tmp: dispersion.main(r_values=[1.0], steps=1, n_xi=8, n_eta=6,
                                out_dir=str(tmp)),
    lambda tmp: scaling.main(n=64, steps=1, quad_n=8),
], ids=["entry", "dryrun", "ref_recipe_score", "dispersion", "scaling"])
def test_entry_points_need_cuda_unless_asked_for_the_cpu(call, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(tmp_path)
    assert not os.listdir(tmp_path)


def _imports(path: str) -> list[str]:
    tree = ast.parse(open(path).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.append(node.module)
    return names


def test_the_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports JAX or the JAX
    package."""
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
        if f.endswith(".py")]
    bad = {f: n for f in files for n in _imports(f)
           if n.split(".")[0] in ("jax", "jaxlib",
                                  "pinn_for_quantum_wavefunction_surfaces_tpu",
                                  "bench", "__graft_entry__")}
    assert not bad
    assert len(files) > 40
