"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy only: it imports neither JAX nor anything of the
program. It is handed the run's initial weights and seed, derives every
batch again (``sampling``), and follows the first Adam steps of the
cell's objective (``objectives``) with psi and lap psi from the ansatz's
equations (``ansatz``). ``follow`` returns what the comparison reads: each
step's loss, the norm of each leaf of the first gradient, and the norm of
each leaf's change over the steps.
"""

from __future__ import annotations

import contextlib

import torch

from .objectives import Adam


def leaf_names(params: dict) -> list[str]:
    """The leaves in the program's flat order: sorted names, then sorted
    fields."""
    return [f"{k}/{f}" for k in sorted(params) for f in sorted(params[k])]


@contextlib.contextmanager
def tf32(on: bool):
    """float32 matrix products on TF32 tensor cores while ``on``."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def follow(params: dict, dtype, steps: int, batch_of, loss_of, lr_of,
           use_tf32=False) -> dict:
    """{"loss": [each step's loss], "grad": {leaf: norm of the first
    gradient}, "grad_steps": {leaf: the norm of its gradient at each
    step}, "change": {leaf: norm of its change after ``steps``}} of
    Adam on ``loss_of(params, batch_of(i))`` at rate ``lr_of(i)``, in
    ``dtype``, with optax's default decays and eps (the recipes')."""
    p = {k: {f: t.detach().to(dtype).clone().requires_grad_(True)
             for f, t in v.items()} for k, v in params.items()}
    names = leaf_names(p)
    leaves = [p[n.split("/")[0]][n.split("/")[1]] for n in names]
    start = [t.detach().clone() for t in leaves]
    opt = Adam(leaves)
    rec = {"loss": [], "grad": {}, "grad_steps": {n: [] for n in names},
           "change": {}}
    with tf32(use_tf32):
        for i in range(steps):
            loss, grads = loss_of(p, batch_of(i))
            rec["loss"].append(loss)
            norms = {n: float(g.double().norm()) for n, g in zip(names, grads)}
            if i == 0:
                rec["grad"] = norms
            for n, v in norms.items():
                rec["grad_steps"][n].append(v)
            opt.step(leaves, grads, lr_of(i))
    rec["change"] = {n: float((t.detach() - s).double().norm())
                     for n, t, s in zip(names, leaves, start)}
    return rec
