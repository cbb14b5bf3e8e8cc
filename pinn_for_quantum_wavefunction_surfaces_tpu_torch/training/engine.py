"""Training engine of the residual PINN: Adam over collocation batches with
resampling, best-params tracking, an EMA and freeze-aware fine-tuning.

The PyTorch counterpart of the JAX package's ``training/engine.py``. The
JAX engine runs ``scan_chunk`` steps as one compiled ``lax.scan`` and reads
the device only between chunks; this engine runs the steps eagerly and also
reads the device only between chunks: resampling is decided on the host from
the step counter, the batch is drawn on the device from an explicit
``torch.Generator``, and the best loss, best params, EMA and per-step
history stay on the device until a chunk ends.

- Resampling: every ``resample_every`` steps while ``step < resample_frac *
  epochs`` (the last 10% train on a frozen batch, which makes best
  selection meaningful).
- Best params: the params with the lowest loss seen at any step (the loss
  is that of the params before the step's update); persisting them
  (``checkpoint_cb``) is gated to ``step > best_after_frac * epochs``.
- Optimiser: ``torch.optim.Adam`` with the JAX betas and eps, whose update
  is optax.adam's formula; ``lr_schedule="step"`` is optax's staircase
  ``exponential_decay``: lr * sc_decay^floor(count / sc_step).
- Freezing: the trainable leaves are views of one flat tensor, the only
  Adam parameter (one ``torch.where`` tracks the best, one op updates the
  EMA); frozen leaves are constants outside it, so autograd computes no
  gradient for them at all (fine-tuning launches no backward kernel).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device, resolve_dtype
from ..models import ansatz
from ..ops.sampling import Batch, sample_batch
from .losses import loss_fn

# Frozen subtrees of the symmetric family's fine-tune stage: only the E
# head (e1, e2, eout) trains. ``finetune`` freezes every other subtree of
# whatever family it is given.
FINETUNE_FROZEN = frozenset({"h1", "h2", "out", "gate1", "gate2"})


class TrainState(NamedTuple):
    step: int
    params: dict          # port params (trainable leaves are views)
    opt_state: Optional[list]   # JAX layout (cli state.npz); None if frozen
    batch: Batch
    best_params: dict
    best_loss: torch.Tensor
    ema_params: dict
    generator: torch.Generator


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    params: dict           # final params (JAX layout, numpy)
    best_params: dict      # lowest-loss params seen
    best_loss: float
    history: dict          # {"Ltot", "Lpde", "Lbc", "Energy"} per step
    runtime_s: float
    points_per_sec: float
    ema_params: dict = None  # Polyak average (== final params if ema off)


class _Layout:
    """Where each trainable leaf lives in the flat vector; frozen leaves
    are constants."""

    def __init__(self, params: dict, frozen: frozenset):
        keys = [(k, f) for k in sorted(params) for f in sorted(params[k])]
        self.train = [kf for kf in keys if kf[0] not in frozen]
        self.frozen = {kf: params[kf[0]][kf[1]].detach() for kf in keys
                       if kf[0] in frozen}
        self.shapes = [params[k][f].shape for k, f in self.train]
        self.sizes = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]

    def flat(self, tree: dict, dtype, device) -> torch.Tensor:
        """The trainable leaves of ``tree`` (tensors or numpy arrays) as one
        fresh vector."""
        def leaf(v):
            v = v if isinstance(v, torch.Tensor) else \
                torch.as_tensor(np.asarray(v))
            return v.detach().reshape(-1).to(device=device, dtype=dtype)
        return torch.cat([leaf(tree[k][f]) for k, f in self.train])

    def tree(self, flat: torch.Tensor, with_frozen: bool = True) -> dict:
        """Params tree of views of ``flat`` (split: one backward kernel)."""
        out: dict = {}
        for (k, f), t, s in zip(self.train, torch.split(flat, self.sizes),
                                self.shapes):
            out.setdefault(k, {})[f] = t.view(s)
        if with_frozen:
            for (k, f), t in self.frozen.items():
                out.setdefault(k, {})[f] = t
        return out


def make_optimizer(cfg: Config, flat: torch.Tensor) -> torch.optim.Adam:
    """Adam with the configured lr, betas and eps over the flat vector (the
    step schedule is applied by ``learning_rate`` before each step)."""
    t = cfg.train
    return torch.optim.Adam([flat], lr=t.lr, betas=tuple(t.betas),
                            eps=t.eps)


def learning_rate(cfg: Config, count: int) -> float:
    """The rate of update number ``count`` (0-based): constant, or optax's
    staircase exponential_decay for ``lr_schedule == "step"``."""
    t = cfg.train
    if t.lr_schedule == "step":
        # optax evaluates the schedule in float32, whatever the params' type
        f32 = np.float32
        return float(f32(t.lr) * f32(t.sc_decay) ** f32(count // t.sc_step))
    return t.lr


def _opt_tree(cfg, opt, flat, layout, sched_count):
    """Adam's state in the JAX package's layout (the flattened optax state
    of ``cli train``'s state.npz): [{count, mu, nu}] plus {count} of the
    schedule with ``lr_schedule == "step"``."""
    st = opt.state.get(flat, {})
    count = int(st["step"]) if st else 0
    zeros = torch.zeros_like(flat)
    tree = [{"count": np.int32(count),
             "mu": layout.tree(st.get("exp_avg", zeros), with_frozen=False),
             "nu": layout.tree(st.get("exp_avg_sq", zeros),
                               with_frozen=False)}]
    if cfg.train.lr_schedule == "step":
        tree.append({"count": np.int32(sched_count)})
    return tree


def _restore_opt(cfg, opt, flat, layout, opt_state) -> int:
    """Load a JAX-layout Adam state (lists or '0'/'1'-keyed dicts, as a
    state.npz reads back) into ``opt``; returns the schedule count."""
    def part(i):
        parts = (list(opt_state) if isinstance(opt_state, (list, tuple))
                 else [opt_state[k] for k in sorted(opt_state, key=int)])
        if i >= len(parts):
            raise KeyError(f"the optimizer state has no leaf opt/{i}/count "
                           "(written with another --lr-schedule)")
        return parts[i]
    adam = part(0)
    count = int(np.asarray(adam["count"]))
    opt.state[flat] = {
        "step": torch.tensor(float(count)),
        "exp_avg": layout.flat(adam["mu"], flat.dtype, flat.device),
        "exp_avg_sq": layout.flat(adam["nu"], flat.dtype, flat.device),
    }
    if cfg.train.lr_schedule == "step":
        return int(np.asarray(part(1)["count"]))
    return count


def train(cfg: Config,
          params: Optional[dict] = None,
          opt_state=None,
          start_step: int = 0,
          frozen: frozenset = frozenset(),
          checkpoint_cb: Optional[Callable[[TrainState, int], None]] = None,
          log_cb: Optional[Callable[[int, dict], None]] = None,
          device="cuda") -> TrainResult:
    """Run the training schedule on ``device``.

    ``cfg.train.epochs`` is the TOTAL schedule length: resuming with
    ``start_step = s`` runs the remaining ``epochs - s`` steps, so the
    resample cutoff, the best-persist gate and the step counter share one
    absolute counter. ``params`` None draws the seeded init
    (``cfg.train.seed``); ``opt_state`` is an Adam state in the JAX layout
    (a state.npz's "opt" tree). The host reads the device every
    ``scan_chunk`` steps: ``log_cb(step, metrics)`` and, past the persist
    gate and on a new best, ``checkpoint_cb(state, step)``."""
    t = cfg.train
    dev = resolve_device(device)
    dtype = resolve_dtype(cfg.dtype)
    if params is None:
        params = ansatz.init_params(cfg.model, seed=t.seed, dtype=dtype,
                                    device=dev)
    params = ansatz.as_params(params, dtype, dev)
    layout = _Layout(params, frozen)
    flat = layout.flat(params, dtype, dev).requires_grad_(True)
    opt = make_optimizer(cfg, flat)
    sched_count = 0
    if opt_state is not None:
        sched_count = _restore_opt(cfg, opt, flat, layout, opt_state)
    gen = torch.Generator(device=dev).manual_seed(int(t.seed))
    batch = sample_batch(gen, cfg, device=dev)
    loss_dtype = torch.promote_types(dtype, torch.float32)
    best_loss = torch.full((), float("inf"), dtype=loss_dtype, device=dev)
    best_flat = flat.detach().clone()
    ema_flat = flat.detach().clone()
    resample_cutoff = int(t.resample_frac * t.epochs)
    d = t.ema_decay

    def state_at(step):
        return TrainState(
            step, layout.tree(flat.detach()),
            None if layout.frozen else _opt_tree(cfg, opt, flat, layout,
                                                 sched_count),
            batch, layout.tree(best_flat), best_loss, layout.tree(ema_flat),
            gen)

    chunks = []
    n_done = start_step
    persist_after = int(t.best_after_frac * t.epochs)
    last_persisted_best = np.inf
    t0 = time.perf_counter()
    while n_done < t.epochs:
        n = min(t.scan_chunk, t.epochs - n_done)
        hist = torch.empty((n, 4), dtype=dtype, device=dev)
        for j in range(n):
            step = n_done + j
            if step % t.resample_every == 0 and step < resample_cutoff:
                batch = sample_batch(gen, cfg, device=dev)
            opt.zero_grad(set_to_none=True)
            l_tot, aux = loss_fn(layout.tree(flat), cfg, batch)
            l_tot.backward()
            with torch.no_grad():
                improved = l_tot < best_loss
                best_flat = torch.where(improved, flat, best_flat)
                best_loss = torch.where(improved, l_tot.to(loss_dtype),
                                        best_loss)
                hist[j] = torch.stack([l_tot, aux.l_pde, aux.l_bc,
                                       aux.e_last])
            opt.param_groups[0]["lr"] = learning_rate(cfg, sched_count)
            opt.step()
            sched_count += 1
            with torch.no_grad():
                ema_flat = d * ema_flat + (1.0 - d) * flat
        n_done += n
        chunks.append(hist.cpu().numpy())
        best = float(best_loss)
        if log_cb is not None:
            last = chunks[-1][-1]
            log_cb(n_done, {"Ltot": float(last[0]), "Lpde": float(last[1]),
                            "Lbc": float(last[2]), "E": float(last[3]),
                            "best": best})
        if (checkpoint_cb is not None and n_done > persist_after
                and best < last_persisted_best):
            checkpoint_cb(state_at(n_done), n_done)
            last_persisted_best = best
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    runtime = time.perf_counter() - t0
    steps_run = n_done - start_step
    h = np.concatenate(chunks) if chunks else np.zeros((0, 4), np.float32)
    history = {"Ltot": h[:, 0], "Lpde": h[:, 1], "Lbc": h[:, 2],
               "Energy": h[:, 3]}
    state = state_at(n_done)
    return TrainResult(
        state=state,
        params=ansatz.to_numpy_params(state.params),
        best_params=ansatz.to_numpy_params(state.best_params),
        best_loss=float(best_loss),
        history=history,
        runtime_s=runtime,
        points_per_sec=steps_run * t.n_train / max(runtime, 1e-9),
        ema_params=ansatz.to_numpy_params(state.ema_params),
    )


def finetune(cfg: Config, params: dict, **kw) -> TrainResult:
    """Stage-2 schedule: freeze the wavefunction sub-networks and train only
    the E(R) head (lr 5e-4, 2000 epochs with ``config.finetune_config``).
    Everything that is not the E head belongs to the wavefunction and is
    frozen, the trainable-exponent and GZ heads included."""
    frozen = frozenset(k for k in params if k not in ("e1", "e2", "eout"))
    return train(cfg, params=params, frozen=frozen, **kw)
