"""Multi-process initialisation of the port's mesh runs.

The PyTorch counterpart of the JAX package's ``parallel/distributed.py``.
JAX brings up one process per host that drives every device of that host;
torch runs one process per device (a "rank"), and ``torch.distributed``
joins them into one process group:

    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.parallel import \\
        distributed
    distributed.initialize()            # torchrun's environment
    mesh = distributed.global_mesh()    # a 1-D mesh over every rank

Under ``torchrun`` ``initialize()`` needs no arguments: it reads
MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK. Elsewhere pass the
rendezvous (``"host:port"``, or a ``tcp://`` or ``file://`` URL), the
number of processes and this process's id. The backend follows the
device: NCCL on CUDA, gloo on the CPU, and nothing else.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    """The process group's backend for ranks on ``device``'s type."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {kind!r}: "
                         "the port's meshes run on cuda (NCCL) or cpu (gloo)")
    return BACKENDS[kind]


def local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's
    LOCAL_RANK; the global rank when that is not set)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> None:
    """Join the job's process group (nothing to do if one is running).

    With no ``coordinator_address`` the rendezvous, world size and rank
    come from torchrun's environment, unless ``num_processes`` and
    ``process_id`` are given. On CUDA the rank's card, cuda:<local rank>,
    becomes the current device first."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = backend_for(dev)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if dev.type == "cuda":
        index = int(os.environ.get("LOCAL_RANK",
                                   process_id if process_id is not None
                                   else os.environ.get("RANK", 0)))
        torch.cuda.set_device(index)
    dist.init_process_group(backend, init_method=init_method, **kw)


def global_mesh(device="cuda"):
    """The 1-D mesh over every rank of the job."""
    from .mesh import make_mesh
    return make_mesh(device=device)


def is_coordinator() -> bool:
    """True on rank 0 (and outside a job): the one rank that writes files
    and prints."""
    return not dist.is_initialized() or dist.get_rank() == 0
