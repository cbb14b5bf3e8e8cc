"""Data parallelism over a 1-D mesh of devices, on torch.distributed.

The PyTorch counterpart of the JAX package's ``parallel/mesh.py``. JAX runs
one process over N devices and shards arrays over a ``Mesh``; torch runs
one process per device (a "rank"), each owning one device and joined by a
process group: NCCL on CUDA (cuda:<local rank>, one card a rank), gloo on
the CPU, and nothing else. Each rank holds the params and optimiser state
whole (replicated) and its contiguous block of every point batch (the
layout of JAX's ``P("data")``); a global mean is a (sum, count) pair
all-reduced over the ranks.

- ``Mesh``: one rank's view of the mesh: size, rank, device, group, and
  the all-reduces (``sum`` is differentiable: its backward all-reduces the
  cotangent, as the transpose of JAX's psum is psum).
- ``make_mesh``: the mesh of the running process group.
- ``launch``: run ``fn(mesh, *args)`` on N ranks: the ranks of a torchrun
  job of that size; this process alone for N = 1; else N spawned
  processes joined by a ``file://`` rendezvous in a temporary directory,
  so that no TCP port can clash.
- ``shard_batch``, ``shard_state``: the rank's block of a global batch;
  a training state on the rank's device with its batch block.
- ``make_shardmap_step``: the explicit per-rank step: each rank draws its
  own sub-batch and differentiates its 1/N share of the global loss.

Every rank runs the same operations on the same all-reduced values, so the
params stay equal bit for bit on every rank, and a run at world size 1
equals the unsharded run bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..device import resolve_device
from ..ops.sampling import Batch
from . import distributed


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the cotangents over the
    ranks."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D data mesh."""

    size: int
    rank: int
    device: torch.device
    group: object = None      # the process group; None: the default one

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        out = t.detach().clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduced sum; differentiable where ``t`` needs a gradient."""
        if torch.is_grad_enabled() and t.requires_grad:
            return _AllReduceSum.apply(t, self.group)
        return self._reduce(t, dist.ReduceOp.SUM)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def sum_grads(self, tensors) -> None:
        """Sum each tensor's ``.grad`` over the ranks, in place, in one
        all-reduce (tensors without one, the same on every rank, are
        left so)."""
        grads = [t.grad for t in tensors if t.grad is not None]
        if len(grads) == 1:
            dist.all_reduce(grads[0], group=self.group)
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()

    def block(self, n: int, what: str = "points") -> slice:
        """This rank's contiguous block of ``n`` items."""
        if n % self.size:
            raise ValueError(f"{n} {what} do not split evenly over "
                             f"{self.size} ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def gather(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


def _devices_here(dev: torch.device) -> int:
    return torch.cuda.device_count() if dev.type == "cuda" else \
        (os.cpu_count() or 1)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh of the running process group: one rank per device, each on
    cuda:<local rank> (or the CPU). Without a running group, ``n_devices``
    None or 1 starts a world-size-1 group in this process (an in-memory
    store); larger meshes run under ``launch`` or torchrun. Raises if
    ``n_devices`` differs from the job's size, or if this host has fewer
    devices than its ranks need: two ranks never share a card."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"a mesh of {n_devices} devices needs {n_devices} ranks: run "
                "under parallel.mesh.launch or torchrun")
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(distributed.backend_for(dev),
                                store=dist.HashStore(), world_size=1, rank=0)
    elif dist.get_backend() != distributed.backend_for(dev):
        raise RuntimeError(f"the running process group is "
                           f"{dist.get_backend()}; a {dev.type} mesh needs "
                           f"{distributed.backend_for(dev)}")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"requested {n} devices, the job has {world} ranks")
    local = distributed.local_rank()
    have = _devices_here(dev)
    if local >= have:
        raise ValueError(f"requested {local + 1} devices on this host, "
                         f"have {have}")
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    return Mesh(size=world, rank=dist.get_rank(), device=dev)


def _rank_main(index, n, kind, rendezvous, result, fn, args, threads):
    """One spawned rank of ``launch``."""
    os.environ["LOCAL_RANK"] = str(index)
    if threads:
        torch.set_num_threads(threads)
    distributed.initialize(rendezvous, n, index, device=kind)
    try:
        out = fn(make_mesh(n, kind), *args)
        if index == 0:
            with open(result + ".part", "wb") as f:
                pickle.dump(out, f)
            os.replace(result + ".part", result)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, device="cuda", args: tuple = (),
           timeout: Optional[float] = None):
    """Run ``fn(mesh, *args)`` on ``n`` ranks and return rank 0's result.

    - Inside a running process group (a rank of a job) ``fn`` runs on this
      rank's mesh.
    - Under torchrun with WORLD_SIZE == n this process joins that job.
    - n = 1 runs in this process, on a world-size-1 group.
    - Else n processes are spawned, one a device, joined by a ``file://``
      rendezvous in a temporary directory; ``fn`` and ``args`` must be
      picklable. On the CPU each takes an n-th of this process's torch
      threads. A rank that raises ends the others; ``timeout`` (s) ends
      them all and raises TimeoutError.

    Raises ValueError if this host has fewer than ``n`` devices (CUDA
    cards, or CPU cores): nothing runs on fewer ranks or shares a card."""
    dev = resolve_device(device)
    n = int(n)
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n < 1 or on_host > _devices_here(dev):
        raise ValueError(f"requested {n} devices, have "
                         f"{_devices_here(dev)}")
    if dist.is_initialized():
        return fn(make_mesh(n, dev.type), *args)
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != n:
            raise ValueError(f"requested {n} devices, the torchrun job has "
                             f"{world} ranks")
        distributed.initialize(device=dev.type)
        try:
            return fn(make_mesh(n, dev.type), *args)
        finally:
            dist.destroy_process_group()
    if n == 1:
        mesh = make_mesh(1, dev.type)
        try:
            return fn(mesh, *args)
        finally:
            dist.destroy_process_group()
    threads = max(1, torch.get_num_threads() // n) if dev.type == "cpu" \
        else 0
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        result = os.path.join(tmp, "result.pkl")
        ctx = torch.multiprocessing.start_processes(
            _rank_main, nprocs=n, join=False, start_method="spawn",
            args=(n, dev.type, "file://" + os.path.join(tmp, "rendezvous"),
                  result, fn, tuple(args), threads))
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks did not finish in "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        with open(result, "rb") as f:
            return pickle.load(f)


def shard_batch(batch: Batch, mesh: Mesh) -> Batch:
    """This rank's contiguous block of a global batch (``P("data")``)."""
    sl = mesh.block(batch.x.shape[0])
    return Batch(*(a[sl].to(mesh.device) for a in batch))


def rank_generator(seed: int, mesh: Mesh) -> torch.Generator:
    """The rank's own stream, seeded from (seed, rank): the port's stand-in
    for JAX's ``fold_in(key, axis_index)``."""
    s = int(np.random.SeedSequence([int(seed), mesh.rank]).generate_state(1)[0])
    return torch.Generator(device=mesh.device).manual_seed(s)


def shard_state(state, cfg: Config, mesh: Mesh):
    """A training state (``engine.TrainState``, its batch global) as this
    rank's live ``engine.Trainer``: params, Adam state, best and EMA
    replicated on the rank's device, the batch the rank's block, and the
    rank's own generator (``rank_generator``)."""
    from ..training import engine
    return engine.Trainer(
        cfg, state.params, opt_state=state.opt_state, start_step=state.step,
        best_params=state.best_params, best_loss=state.best_loss,
        ema_params=state.ema_params, batch=shard_batch(state.batch, mesh),
        generator=rank_generator(cfg.train.seed, mesh), mesh=mesh)


def make_shardmap_step(cfg: Config, mesh: Mesh):
    """The explicit per-rank training step: ``(step, n_local)``, where
    ``step(trainer)`` advances this rank's ``engine.Trainer`` (see
    ``shard_state``) by one step and returns its ``engine.History``.

    Each rank draws its own sub-batch of n_train / N points from its own
    generator when the schedule resamples, evaluates the exact global loss
    through ``losses.loss_fn`` with the differentiable all-reduce (every
    batch reduction, the normalisers of the scale-invariant, LCAO-weighted
    and correction-regularised losses included, is a (sum, count) pair
    summed over the ranks), differentiates its 1/N share and sums the
    gradients: the exact global loss and gradient. The history's energy is
    E at the global last point, the last rank's last one."""
    from ..ops.sampling import sample_batch
    if cfg.train.n_train % mesh.size:
        raise ValueError(f"n_train={cfg.train.n_train} not divisible by "
                         f"{mesh.size} devices")
    n_local = cfg.train.n_train // mesh.size

    def sample(gen):
        return sample_batch(gen, cfg, n=n_local, device=mesh.device)

    def step(trainer):
        return trainer.advance(sample)

    return step, n_local
