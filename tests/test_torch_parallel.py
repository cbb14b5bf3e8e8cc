"""The port's multi-device paths (parallel/, the ``mesh=`` paths of
training and scoring) on two gloo ranks against the JAX package's
single-device functions, case by case after tests/test_parallel.py,
tests/test_distributed.py and tests/test_sharded_quadrature.py.

The two ranks start once for the module (``parallel.mesh.launch`` with a
``file://`` rendezvous in a temporary directory, one torch thread a rank,
a timeout of their own) and run every case in tests/torch_rank_jobs.py on
the same numpy inputs: the JAX package's params and batches, carried
across. The JAX references run here, in the test process. float64
throughout; tolerances are the JAX tests' own:
- the sharded loss rtol 1e-12; engine.train(mesh=) against the JAX
  package's train(): the loss history rtol 1e-8, params rtol 1e-7 (atol
  1e-12); one shard-map step against the JAX step: loss rtol 1e-10,
  params rtol 1e-9 (atol 1e-14), in every loss mode; E of the global
  last point rtol 1e-12; the sharded quadrature rtol 1e-12;
- the sharded polish: its objective rtol 1e-12 and gradient 1e-10 of its
  largest entry against the JAX package's quotient (plain and deflated) on
  the same rows; the polish itself against the port's unsharded polish
  rtol 1e-8 (atol 1e-12), the JAX test's tolerance. The polish is not held
  to the JAX package's trajectory: its optimisers differ (torch's line
  search, not optax's zoom), as ROADMAP's "L-BFGS differs" contract says;
- bit for bit: two sharded backward passes, and the params on both ranks.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu.analysis import energy as jen
from pinn_for_quantum_wavefunction_surfaces_tpu.models import ansatz as jans
from pinn_for_quantum_wavefunction_surfaces_tpu.training import \
    distill as jdistill
from pinn_for_quantum_wavefunction_surfaces_tpu.training import engine as jeng
from pinn_for_quantum_wavefunction_surfaces_tpu.training import losses as jlo
from pinn_for_quantum_wavefunction_surfaces_tpu.training import \
    variational as jvar
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
    ansatz as tans
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.parallel import \
    mesh as pmesh
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
    variational as tvar

import torch_rank_jobs
from test_torch_excited import one_torch_thread  # noqa: F401
from test_torch_sampling_losses import port_cfg
from test_torch_separable import jax_model, load_artifact, \
    no_jax_cache_writes  # noqa: F401

RANKS = 2
# seconds the two-rank job may take before it fails its tests (it takes
# 20-40 s alone on this host's CPU)
JOB_TIMEOUT = 600
# tests/test_parallel.py's polish
POLISH_KW = dict(n_r=8, n_xi=10, n_eta=8, steps=3, adam_steps=2)
MODES = {"scale_invariant": dict(scale_invariant=True),
         "lcao_weight": dict(residual_weight="lcao"),
         "correction_reg": dict(correction_reg=0.1),
         "all": dict(scale_invariant=True, residual_weight="lcao",
                     correction_reg=0.1)}
# the shard-map step's cases: the plain loss, then every mode
STEPS = {"plain": {}, **MODES}
QUAD_CASES = (("model", 2.0, 30), ("model", 2.0, 31), ("lcao", 1.0, 32))


def jax_cfg(**train):
    cfg = pqs.smoke_config(dtype="float64")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, n_train=2048, epochs=8, scan_chunk=4, **train))


def jax_state(cfg, seed):
    return jeng.init_state(jax.random.PRNGKey(seed), cfg,
                           jeng.make_optimizer(cfg))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def dual_vbatch_arrays(cfg, n_r, n_xi, n_eta):
    """The polish's training batch (both grids' rows) as numpy: the same
    deterministic grids in both packages."""
    vb = tvar.dual_grid_vbatch(cfg, n_r, n_xi, n_eta, device="cpu")
    return [a.numpy() for a in vb]


def xnode_model():
    mcfg = pqs.ModelConfig(arch="separable", xi_node=True)
    params = np_tree(jans.init_params(jax.random.PRNGKey(3), mcfg,
                                      jnp.float64))
    rng = np.random.default_rng(3)
    for k in ("lamout", "muout"):
        params[k]["w"] = params[k]["w"] + rng.normal(0, 0.1,
                                                     params[k]["w"].shape)
    return mcfg, params


@pytest.fixture(scope="module")
def inputs():
    """The job's inputs, built with the JAX package in this process."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    try:
        cfg = jax_cfg()
        st = jax_state(cfg, 0)
        frozen = jax_cfg(resample_frac=0.0)
        st_train = jax_state(frozen, frozen.train.seed)
        mcfg_s, _, params_s = jax_model()
        mcfg_x, params_x = xnode_model()
        pcfg = pqs.Config(dtype="float64", model=mcfg_s)
        pcfg_x = pqs.Config(dtype="float64", model=mcfg_x)
        qcfg = pqs.Config(dtype="float64")
        return {
            "jax": {"cfg": cfg, "frozen": frozen, "pcfg": pcfg,
                    "pcfg_x": pcfg_x, "qcfg": qcfg},
            "cfg": port_cfg(cfg),
            "params": np_tree(st.params),
            "batch": [np.asarray(a) for a in st.batch],
            "cfg_train": port_cfg(frozen),
            "params_train": np_tree(st_train.params),
            "batch_train": [np.asarray(a) for a in st_train.batch],
            "mode_cfgs": {m: port_cfg(jax_cfg(resample_frac=0.0, **kw))
                          for m, kw in STEPS.items()},
            "polish": {
                "cfg": port_cfg(pcfg), "params": params_s,
                # tests/test_parallel.py's polish starts from the plain
                # init (a rougher start sends the line search through
                # 19 trials, whose path the order of the sums decides)
                "init": np_tree(jans.init_params(
                    jax.random.PRNGKey(0), mcfg_s, jnp.float64)),
                "cfg_x": port_cfg(pcfg_x), "params_x": params_x,
                "refs": [load_artifact("flagship_separable.npz")],
                "vb": dual_vbatch_arrays(port_cfg(pcfg), 4, 10, 8),
                "kw": POLISH_KW},
            "quadrature": {
                "cfg": port_cfg(qcfg),
                "params": np_tree(jans.init_params(
                    jax.random.PRNGKey(0), qcfg.model, jnp.float64)),
                "cases": QUAD_CASES, "n": 16, "r": [1.0, 2.0],
                "steps": 50},
        }
    finally:
        jax.config.update(key, old)


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every case, run once on two gloo ranks."""
    job = {k: v for k, v in inputs.items() if k != "jax"}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return pmesh.launch(torch_rank_jobs.parallel_job, RANKS,
                            device="cpu", args=(job,), timeout=JOB_TIMEOUT)
    finally:
        torch.set_num_threads(threads)


def assert_trees_close(want, got, rtol, atol):
    assert sorted(want) == sorted(got)
    for k in want:
        for f in want[k]:
            np.testing.assert_allclose(got[k][f], np.asarray(want[k][f]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{k}/{f}")


def test_two_process_psum(tmp_path):
    """initialize() on an explicit file:// rendezvous in two processes,
    global_mesh() of size 2, and an all-reduce of (rank + 1) giving 3."""
    ctx = torch.multiprocessing.start_processes(
        torch_rank_jobs.psum_job, nprocs=2, join=False,
        start_method="spawn",
        args=("file://" + str(tmp_path / "rendezvous"),))
    try:
        for _ in range(240):
            if ctx.join(timeout=1.0):
                break
        else:
            raise TimeoutError("the two processes did not finish")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in ctx.processes] == [0, 0]


def test_ranks_see_the_mesh(ranks):
    assert ranks["size"] == RANKS
    assert ranks["rank_device"] == "cpu"
    assert ranks["coordinator"] is True


def test_pjit_loss_matches_single_device(inputs, ranks):
    """The loss of the blocks of the batch, its sums all-reduced, equals
    the JAX package's loss of the whole batch."""
    j = inputs["jax"]
    l_single, aux = jlo.loss_fn(inputs["params"], j["cfg"],
                                jax_state(j["cfg"], 0).batch)
    np.testing.assert_allclose(ranks["loss"][0], float(l_single),
                               rtol=1e-12)
    np.testing.assert_allclose(ranks["loss"][1], float(aux.l_bc),
                               rtol=1e-12)


def test_sharded_backward_repeats_bit_for_bit(ranks):
    """Two sharded backward passes (the loss's and the polish objective's,
    plain and deflated) give the same gradients bit for bit."""
    assert ranks["loss_backward_repeats"]
    assert ranks["quotient"]["repeat"]
    assert ranks["quotient_deflated"]["repeat"]


def test_pjit_training_matches_single_device(inputs, ranks):
    """engine.train(mesh=) on the JAX package's init and batch (frozen)
    equals the JAX package's train(), and leaves the same params on both
    ranks."""
    ref = jeng.train(inputs["jax"]["frozen"])
    got = ranks["train"]
    np.testing.assert_allclose(got["Ltot"], np.asarray(ref.history["Ltot"]),
                               rtol=1e-8)
    assert_trees_close(np_tree(ref.params), got["params"], 1e-7, 1e-12)
    assert ranks["train_same_on_ranks"]


def test_shardmap_step_runs_and_reduces(ranks):
    """The explicit step: each rank samples n_train / 2 points; finite,
    falling loss; the same params on both ranks."""
    assert ranks["n_local"] == 2048 // RANKS
    hist = ranks["shardmap_hist"]
    assert np.isfinite(hist).all()
    assert hist[-1] < hist[0]
    assert ranks["shardmap_same_on_ranks"]


def _jax_single_step(cfg, params, batch):
    opt = jeng.make_optimizer(cfg)
    st = jeng.init_state(jax.random.PRNGKey(0), cfg, opt)
    st = st._replace(step=jnp.ones((), jnp.int32), params=params,
                     batch=batch, best_params=params, ema_params=params)
    return jax.jit(jeng.make_step(cfg, opt))(st, None)


def assert_step_matches(inputs, ranks, mode):
    """One shard-map step from the JAX package's state and frozen batch
    equals its single-device step: the same losses and updated params."""
    cfg = jax_cfg(resample_frac=0.0, **STEPS[mode])
    st = jax_state(inputs["jax"]["cfg"], 0)
    s1, h1 = _jax_single_step(cfg, st.params, st.batch)
    got = ranks["modes"][mode]
    for name in ("l_tot", "l_pde", "l_bc"):
        np.testing.assert_allclose(got[name], float(getattr(h1, name)),
                                   rtol=1e-10, err_msg=name)
    assert_trees_close(np_tree(s1.params), got["params"], 1e-9, 1e-14)


def test_shardmap_matches_pjit_gradients(inputs, ranks):
    assert_step_matches(inputs, ranks, "plain")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_shardmap_full_loss_modes_match_single_device(inputs, ranks, mode):
    """Every loss mode (the global normalisers included) on the shard-map
    step."""
    assert_step_matches(inputs, ranks, mode)


def test_shardmap_e_last_is_global_last_point(inputs, ranks):
    """The history's E is E at the global batch's last point."""
    st = jax_state(inputs["jax"]["cfg"], 0)
    want = float(jans.energy(st.params, st.batch.r[-1:])[0])
    for mode in STEPS:
        np.testing.assert_allclose(ranks["modes"][mode]["energy"], want,
                                   rtol=1e-12)


def _jax_quotient(cfg, params, vb_arrays, refs=None):
    vb = jvar.VBatch(*(jnp.asarray(a) for a in vb_arrays))
    if refs is None:
        def f(p):
            return jvar.quotient_loss(p, cfg, vb)[0]
    else:
        psi0, hpsi0 = jvar.reference_states_on_batch(refs, cfg, vb)

        def f(p):
            return jvar.quotient_loss_deflated(p, cfg, vb, psi0, hpsi0)[0]
    v, g = jax.value_and_grad(f)(params)
    flat = np.concatenate([np.asarray(g[k][f]).reshape(-1)
                           for k in sorted(g) for f in sorted(g[k])])
    return float(v), flat


@pytest.mark.parametrize("deflated", [False, True])
def test_sharded_quotient_matches_single_device(inputs, ranks, deflated):
    """The sharded polish's objective and gradient (each rank's R rows,
    the means over R and the gradient all-reduced; deflated: the
    references' rows split along axis 1) equal the JAX package's quotient
    on all the rows."""
    pol = inputs["polish"]
    if deflated:
        want = _jax_quotient(inputs["jax"]["pcfg_x"], pol["params_x"],
                             pol["vb"], pol["refs"])
        got = ranks["quotient_deflated"]
    else:
        want = _jax_quotient(inputs["jax"]["pcfg"], pol["params"],
                             pol["vb"])
        got = ranks["quotient"]
    np.testing.assert_allclose(got["value"], want[0], rtol=1e-12)
    err = np.max(np.abs(got["grads"] - want[1]))
    assert err <= 1e-10 * np.max(np.abs(want[1])), err


def test_sharded_spheroidal_polish_matches_single_device(
        inputs, ranks, one_torch_thread):  # noqa: F811
    """polish_spheroidal(mesh=) on two ranks, plain and deflated, equals
    the unsharded polish, and leaves the same params on both ranks."""
    pol = inputs["polish"]
    ref = tvar.polish_spheroidal(pol["init"], pol["cfg"], device="cpu",
                                 **pol["kw"])
    assert_trees_close(tans.to_numpy_params(ref), ranks["polish"], 1e-8,
                       1e-12)
    ref_x = tvar.polish_spheroidal(pol["params_x"], pol["cfg_x"],
                                   deflate_params=pol["refs"], device="cpu",
                                   **pol["kw"])
    assert_trees_close(tans.to_numpy_params(ref_x),
                       ranks["polish_deflated"], 1e-8, 1e-12)
    assert ranks["polish_same_on_ranks"]


@pytest.mark.parametrize("case", QUAD_CASES, ids=lambda c: f"{c[0]}-n{c[2]}")
def test_sharded_quadrature_matches_single_device(inputs, ranks, case):
    """rayleigh_quotient_sharded (the x axis split over two ranks, padded
    with zero-weight nodes where n is odd) equals the JAX package's
    single-device quotient; LCAO too."""
    which, ri, n = case
    q = inputs["quadrature"]
    want = jen.rayleigh_quotient(q["params"], inputs["jax"]["qcfg"], ri,
                                 n=n, which=which)
    np.testing.assert_allclose(ranks["quadrature"][case], want, rtol=1e-12)


def test_distill_mesh_targets_match_single_device(inputs, ranks):
    """distill(mesh=)'s targets are the sharded quotients, equal to the
    JAX package's rayleigh_targets on the uniform grid."""
    q = inputs["quadrature"]
    _, want = jdistill.rayleigh_targets(q["params"], inputs["jax"]["qcfg"],
                                        q["r"], n=q["n"], grid="uniform")
    np.testing.assert_allclose(ranks["distill"]["targets"], want,
                               rtol=1e-12)
    assert np.isfinite(ranks["distill"]["fit_rms"])


def test_launch_refuses_more_devices_than_the_host_has():
    """N beyond the devices there are raises: nothing runs on fewer ranks
    or two ranks on one card."""
    with pytest.raises(ValueError, match="requested"):
        pmesh.launch(torch_rank_jobs.parallel_job, (os.cpu_count() or 1) + 1,
                     device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.launch(torch_rank_jobs.parallel_job, 2, device="cuda")
