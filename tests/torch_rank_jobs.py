"""Jobs that the port's multi-device tests run on gloo ranks.

``tests/test_torch_parallel.py`` and ``tests/test_torch_sweep.py`` start
two CPU ranks once per module (``parallel.mesh.launch``) and run one of
these jobs there: every case of the module on the same numpy inputs, rank
0's results returned to the test process, which holds them against the
JAX package. The ranks import torch and the port only (this module, not
the test modules, is what they unpickle), and run torch on one thread
each.
"""

import functools

import numpy as np
import torch

from pinn_for_quantum_wavefunction_surfaces_tpu_torch.analysis import \
    energy
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import ansatz
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops.sampling import \
    Batch
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.parallel import \
    distributed
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.parallel import \
    mesh as pmesh
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import (
    distill, engine, losses, sweep, variational)


def batch_of(arrays) -> Batch:
    return Batch(*(torch.as_tensor(np.array(a)) for a in arrays))


def _flat_grads(leaves) -> np.ndarray:
    return torch.cat([t.grad.reshape(-1) for t in leaves]).numpy()


def _same_on_ranks(mesh, arrays) -> bool:
    """Whether every rank holds these arrays bit for bit."""
    mine = [np.asarray(a) for a in arrays]
    return all(len(o) == len(mine) and all(np.array_equal(a, b)
                                           for a, b in zip(o, mine))
               for o in mesh.gather(mine))


def _leaves(params: dict) -> list:
    return [params[k][f] for k in sorted(params) for f in sorted(params[k])]


def _numpy_leaves(params: dict) -> list:
    return [t.detach().numpy() for t in _leaves(params)]


def _fresh_state(params, batch, step: int) -> engine.TrainState:
    """A new run's state, as the JAX package's ``init_state`` gives it."""
    return engine.TrainState(step, params, None, batch, None, None, None,
                             None)


def loss_and_grads(mesh, loss, leaves) -> tuple[float, np.ndarray]:
    """The global loss and the summed gradient of the rank's share."""
    for t in leaves:
        t.grad = None
    variational._backward(loss, leaves, mesh)
    return float(loss), _flat_grads(leaves)


def quotient_case(mesh, cfg, params, vb_arrays, refs=None):
    """The sharded quotient objective (deflated against ``refs``) and its
    gradient at ``params`` on this rank's rows of the batch, twice: the
    second pass must repeat the first bit for bit."""
    vb = variational.VBatch(*(torch.as_tensor(a) for a in vb_arrays))
    sl = mesh.block(vb.r.shape[0], "R rows")
    vb = variational.VBatch(*(a[sl] for a in vb))
    p = variational._trainable(ansatz.as_params(params, torch.float64,
                                                "cpu"))
    leaves = _leaves(p)
    if refs is None:
        def f():
            return variational.quotient_loss(p, cfg, vb, mesh=mesh)[0]
    else:
        frozen = [ansatz.as_params(r, torch.float64, "cpu") for r in refs]
        psi0, hpsi0 = variational.reference_states_on_batch(frozen, cfg, vb)

        def f():
            return variational.quotient_loss_deflated(p, cfg, vb, psi0,
                                                      hpsi0, mesh=mesh)[0]
    v1, g1 = loss_and_grads(mesh, f(), leaves)
    v2, g2 = loss_and_grads(mesh, f(), leaves)
    return {"value": v1, "grads": g1,
            "repeat": v1 == v2 and np.array_equal(g1, g2)}


def parallel_job(mesh, inp: dict) -> dict:
    """Every case of tests/test_torch_parallel.py on this rank."""
    torch.set_num_threads(1)
    out = {"size": mesh.size, "rank_device": str(mesh.device),
           "coordinator": distributed.is_coordinator()}
    cfg, params = inp["cfg"], inp["params"]
    batch = batch_of(inp["batch"])

    # the loss on the sharded batch, and two backward passes
    p = variational._trainable(ansatz.as_params(params, torch.float64,
                                                "cpu"))
    local = pmesh.shard_batch(batch, mesh)
    l_tot, aux = losses.loss_fn(p, cfg, local, allreduce=mesh.sum)
    out["loss"] = (float(l_tot), float(aux.l_bc))
    leaves = _leaves(p)
    _, g1 = loss_and_grads(mesh, l_tot, leaves)
    _, g2 = loss_and_grads(mesh, losses.loss_fn(
        p, cfg, local, allreduce=mesh.sum)[0], leaves)
    out["loss_backward_repeats"] = bool(np.array_equal(g1, g2))

    # engine.train(mesh=): the global batch's blocks, frozen
    res = engine.train(inp["cfg_train"], params=inp["params_train"],
                       batch=batch_of(inp["batch_train"]), mesh=mesh,
                       device="cpu")
    out["train"] = {"Ltot": res.history["Ltot"], "params": res.params,
                    "best_loss": res.best_loss}
    out["train_same_on_ranks"] = _same_on_ranks(
        mesh, [a for v in res.params.values() for a in v.values()])

    # the explicit shard-map step: own sub-batches, 8 steps
    trainer = pmesh.shard_state(_fresh_state(params, batch, 0), cfg, mesh)
    step, n_local = pmesh.make_shardmap_step(cfg, mesh)
    out["n_local"] = n_local
    out["shardmap_hist"] = [float(step(trainer).l_tot) for _ in range(8)]
    out["shardmap_same_on_ranks"] = _same_on_ranks(
        mesh, _numpy_leaves(trainer.state().params))

    # one step from a frozen batch in every loss mode
    out["modes"] = {}
    for mode, mcfg in inp["mode_cfgs"].items():
        trainer = pmesh.shard_state(_fresh_state(params, batch, 1), mcfg,
                                    mesh)
        step, _ = pmesh.make_shardmap_step(mcfg, mesh)
        h = step(trainer)
        out["modes"][mode] = {
            "l_tot": float(h.l_tot), "l_pde": float(h.l_pde),
            "l_bc": float(h.l_bc), "energy": float(h.energy),
            "params": ansatz.to_numpy_params(trainer.state().params)}

    # the spheroidal polish: its objective and gradient, plain and
    # deflated; the polish itself
    pol = inp["polish"]
    out["quotient"] = quotient_case(mesh, pol["cfg"], pol["params"],
                                    pol["vb"])
    out["quotient_deflated"] = quotient_case(
        mesh, pol["cfg_x"], pol["params_x"], pol["vb"], refs=pol["refs"])
    polished = variational.polish_spheroidal(pol["init"], pol["cfg"],
                                             mesh=mesh, **pol["kw"])
    out["polish"] = ansatz.to_numpy_params(polished)
    polished_x = variational.polish_spheroidal(
        pol["params_x"], pol["cfg_x"], mesh=mesh,
        deflate_params=pol["refs"], **pol["kw"])
    out["polish_deflated"] = ansatz.to_numpy_params(polished_x)
    out["polish_same_on_ranks"] = _same_on_ranks(
        mesh, _numpy_leaves(polished) + _numpy_leaves(polished_x))

    # the sharded quadrature and the distillation's targets
    q = inp["quadrature"]
    qp = ansatz.as_params(q["params"], torch.float64, "cpu")
    out["quadrature"] = {
        (which, ri, n): energy.rayleigh_quotient_sharded(
            qp, q["cfg"], ri, mesh, n=n, which=which)
        for which, ri, n in q["cases"]}
    # the head fit's 8 000 L-BFGS steps are the E head's own business and
    # take a minute and a half here: 200 show that it runs on the targets
    fit = distill.fit_energy_head
    distill.fit_energy_head = functools.partial(fit, lbfgs_steps=200)
    try:
        _, info = distill.distill(qp, q["cfg"], n=q["n"], r_values=q["r"],
                                  steps=q["steps"], mesh=mesh)
    finally:
        distill.fit_energy_head = fit
    out["distill"] = {"targets": info["targets"], "fit_rms": info["fit_rms"]}
    return out


def psum_job(index: int, rendezvous: str) -> None:
    """One process of the two-process all-reduce: ``initialize`` on an
    explicit rendezvous, ``global_mesh``, and every rank contributing its
    id + 1 to a sum of 3."""
    torch.set_num_threads(1)
    distributed.initialize(rendezvous, 2, index, device="cpu")
    try:
        assert distributed.is_coordinator() == (index == 0)
        mesh = distributed.global_mesh(device="cpu")
        assert (mesh.size, mesh.rank) == (2, index), mesh
        total = float(mesh.sum(torch.tensor([float(index + 1)]))[0])
        assert total == 3.0, total
    finally:
        torch.distributed.destroy_process_group()


def sweep_job(mesh, inp: dict) -> dict:
    """The vmapped sweep with the models split over the ranks, from the
    JAX package's per-model initial states; and a family that does not
    split evenly."""
    torch.set_num_threads(1)
    init = [(p, batch_of(b)) for p, b in inp["init"]]
    out = sweep.train_per_r_vmapped(inp["cfg"], inp["r"], mesh=mesh,
                                    init=init, device="cpu")
    out["same_on_ranks"] = _same_on_ranks(
        mesh, [out["loss_history"], out["E_net"]])
    try:
        sweep.train_per_r_vmapped(inp["cfg"], inp["r"][:3], mesh=mesh,
                                  device="cpu")
        out["uneven"] = None
    except ValueError as exc:
        out["uneven"] = str(exc)
    return out


def entry_points_job(mesh, inp: dict) -> dict:
    """tests/test_torch_entry_points.py's multi-rank cases on this rank:
    the dry run (its own checks raise on a mismatch) and a row of the
    scaling benchmark with its sharded quadrature."""
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import graft_entry
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.benchmarks import \
        scaling
    torch.set_num_threads(1)
    return {"dryrun": graft_entry.dryrun_multichip(mesh.size, device="cpu"),
            "scaling": scaling._row(mesh, **inp["scaling"])}


def bfloat16_job(mesh) -> dict:
    """engine.train and the spheroidal polish in bfloat16 on this rank of
    the mesh (seeded inits and batches, smoke sizes): rank 0's loss
    history, and whether every rank holds the same params bit for bit."""
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config
    torch.set_num_threads(1)
    cfg = config.Config(
        model=config.ModelConfig(gz=True, trainable_exponent=True),
        train=config.TrainConfig(n_train=256, epochs=4), dtype="bfloat16")
    res = engine.train(cfg, mesh=mesh, device="cpu")
    scfg = config.Config(model=config.ModelConfig(arch="separable"),
                         dtype="bfloat16")
    polished = variational.polish_spheroidal(
        None, scfg, n_r=4, n_xi=8, n_eta=6, steps=2, adam_steps=2,
        mesh=mesh, device="cpu")
    return {
        "train_Ltot": res.history["Ltot"],
        "train_same_on_ranks": _same_on_ranks(mesh, [
            a.view(np.int16) for v in res.params.values()
            for a in v.values()]),
        "polish_dtype": str(polished["lam1"]["w"].dtype),
        "polish_same_on_ranks": _same_on_ranks(mesh, [
            t.view(torch.int16).numpy() for t in _leaves(polished)]),
    }
