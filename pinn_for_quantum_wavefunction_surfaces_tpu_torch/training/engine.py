"""Training engine of the residual PINN: Adam over collocation batches with
resampling, best-params tracking, an EMA and freeze-aware fine-tuning.

The PyTorch counterpart of the JAX package's ``training/engine.py``. The
JAX engine runs ``scan_chunk`` steps as one compiled ``lax.scan`` and reads
the device only between chunks. Here one step is captured once as a CUDA
graph and replayed every step (``training/graphs.py``), and the host also
reads the device only between chunks: resampling is decided on the host from
the step counter (the JAX engine's ``lax.cond``) and replays a captured draw
into the static batch, the batch is drawn on the device from an explicit
``torch.Generator``, and the best loss, best params, EMA and per-step
history stay in static device buffers until a chunk ends.

- Resampling: every ``resample_every`` steps while ``step < resample_frac *
  epochs`` (the last 10% train on a frozen batch, which makes best
  selection meaningful).
- Best params: the params with the lowest loss seen at any step (the loss
  is that of the params before the step's update); persisting them
  (``checkpoint_cb``) is gated to ``step > best_after_frac * epochs``.
- Optimiser: ``Adam``, optax.adam's update (the JAX engine's optimiser)
  written as in-place tensor ops, with the step count and the rate as
  device tensors; ``lr_schedule="step"`` is optax's staircase
  ``exponential_decay``: lr * sc_decay^floor(count / sc_step).
- Freezing: the trainable leaves are views of one flat tensor, the only
  Adam parameter (one ``torch.where`` tracks the best, one op updates the
  EMA); frozen leaves are constants outside it, so autograd computes no
  gradient for them at all (fine-tuning launches no backward kernel).
- Capture: on a CUDA device without a mesh, by default (``graph=True``);
  eager on the CPU, which only the tests ask for, and under a mesh, whose
  all-reduces stay eager. ``graph=False`` forces the eager step, which
  equals the captured one bit for bit.
- Mesh: ``train(..., mesh=)`` runs on every rank of a
  ``parallel.mesh.Mesh``, the batch sharded over the ranks and the loss's
  sums and the gradient all-reduced (``Trainer``).
- Tracing (``utils/profiling.py``, off by default): spans around each step
  and chunk read, phase marks inside the step (``Trainer.phases``), and
  each chunk's ``log_cb`` record gains the last step's phase ms.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device, resolve_dtype
from ..io.checkpoint import as_tensor
from ..models import ansatz
from ..ops.sampling import Batch, sample_batch
from ..parallel.mesh import shard_batch
from ..utils import profiling
from . import graphs
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
            v = v if isinstance(v, torch.Tensor) else as_tensor(v)
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


class Adam:
    """optax.adam (the JAX package's optimiser) on one flat vector, its
    update written as in-place tensor ops on buffers that stay where they
    are, so that a CUDA graph can capture it. The step count and the rate
    are 0-d tensors on the vector's device; ``set_lr`` sets the rate from
    the host before a step. The moments ``mu`` and ``nu`` take the
    vector's type, as optax's do; the update runs in the work type
    (float32 for bfloat16) and each stored value is rounded once.

    Per step, as optax computes it: mu = (1 - b1) g + b1 mu, nu = (1 - b2)
    g^2 + b2 nu, the bias corrections 1 - b^count in the work type cast to
    the moments' type, and p - lr (mu / bc1) / (sqrt(nu / bc2) + eps)."""

    def __init__(self, flat: torch.Tensor, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.flat = flat
        self.b1, self.b2, self.eps = b1, b2, eps
        self.work = torch.promote_types(flat.dtype, torch.float32)
        self.mu = torch.zeros_like(flat)
        self.nu = torch.zeros_like(flat)
        self.count = torch.zeros((), dtype=self.work, device=flat.device)
        self.lr = torch.full((), lr, dtype=flat.dtype, device=flat.device)
        self._lr = lr

    def set_lr(self, lr: float) -> None:
        """The rate of the next steps (one fill, when it changes)."""
        if lr != self._lr:
            self.lr.fill_(lr)
            self._lr = lr

    @torch.no_grad()
    def step(self, grad: torch.Tensor) -> None:
        """One update of the vector from its gradient."""
        b1, b2, w = self.b1, self.b2, self.work
        dtype = self.flat.dtype
        self.count.add_(1)
        bc1 = (1 - torch.pow(b1, self.count)).to(dtype).to(w)
        bc2 = (1 - torch.pow(b2, self.count)).to(dtype).to(w)
        g = grad.to(w)
        mu = (1 - b1) * g + b1 * self.mu.to(w)
        nu = (1 - b2) * (g * g) + b2 * self.nu.to(w)
        self.mu.copy_(mu)
        self.nu.copy_(nu)
        self.flat.copy_(self.flat.to(w) - self.lr.to(w) * (
            (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)))


def make_optimizer(cfg: Config, flat: torch.Tensor) -> Adam:
    """Adam with the configured lr, betas and eps over the flat vector (the
    step schedule is applied by ``learning_rate`` before each step)."""
    t = cfg.train
    return Adam(flat, lr=t.lr, b1=t.betas[0], b2=t.betas[1], eps=t.eps)


def learning_rate(cfg: Config, count: int) -> float:
    """The rate of update number ``count`` (0-based): constant, or optax's
    staircase exponential_decay for ``lr_schedule == "step"``."""
    t = cfg.train
    if t.lr_schedule == "step":
        # optax evaluates the schedule in float32, whatever the params' type
        f32 = np.float32
        return float(f32(t.lr) * f32(t.sc_decay) ** f32(count // t.sc_step))
    return t.lr


def _opt_tree(cfg, opt: Adam, layout, sched_count):
    """Adam's state in the JAX package's layout (the flattened optax state
    of ``cli train``'s state.npz): [{count, mu, nu}] plus {count} of the
    schedule with ``lr_schedule == "step"``."""
    tree = [{"count": np.int32(int(opt.count)),
             "mu": layout.tree(opt.mu, with_frozen=False),
             "nu": layout.tree(opt.nu, with_frozen=False)}]
    if cfg.train.lr_schedule == "step":
        tree.append({"count": np.int32(sched_count)})
    return tree


def _restore_opt(cfg, opt: Adam, layout, opt_state) -> int:
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
    opt.count.fill_(count)
    for buf, key in ((opt.mu, "mu"), (opt.nu, "nu")):
        buf.copy_(layout.flat(adam[key], buf.dtype, buf.device))
    if cfg.train.lr_schedule == "step":
        return int(np.asarray(part(1)["count"]))
    return count


class History(NamedTuple):
    """One step's history row (the JAX package's ``engine.History``)."""
    l_tot: torch.Tensor
    l_pde: torch.Tensor
    l_bc: torch.Tensor
    energy: torch.Tensor   # E at the batch's (global) last point


class Trainer:
    """One training run's live state on a device, one rank's with a mesh:
    the step counter, the trainable vector and its Adam state, the batch,
    the best loss and params, the EMA and the generator. ``advance`` takes
    one step; ``state()`` is its ``TrainState``.

    Every tensor a step reads or writes is a static buffer, updated in
    place: ``flat``, Adam's moments, ``best_flat``, ``best_loss``,
    ``ema_flat``, the ``batch`` (assigning one copies into it) and the
    history ``row`` of the last step. So with ``graph`` on a CUDA device
    without a mesh the step is captured as a CUDA graph at its second call
    and replayed from then on, and so is the draw of a resample
    (``graphs.StepGraph``); on the CPU, under a mesh, or with ``graph``
    False every step runs eagerly, the same arithmetic.

    With ``mesh`` the batch is this rank's block of the global batch, every
    batch sum and count of the loss is all-reduced over the ranks
    (``Mesh.sum``, differentiable), each rank differentiates its 1/N share
    of the global loss, and the gradients are summed: every rank then
    applies the same update to the same params, and tracks the best on the
    same global loss.

    The loss is ``loss`` (``losses.loss_fn``: the kernel route on CUDA);
    a subclass may put another function of the same signature there."""

    loss = staticmethod(loss_fn)

    def __init__(self, cfg: Config, params: Optional[dict] = None,
                 opt_state=None, start_step: int = 0,
                 frozen: frozenset = frozenset(), best_params=None,
                 best_loss=None, ema_params=None, batch=None,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 device="cuda", graph: bool = True):
        t = cfg.train
        self.cfg, self.mesh = cfg, mesh
        dev = mesh.device if mesh is not None else resolve_device(device)
        dtype = resolve_dtype(cfg.dtype)
        if params is None:
            params = ansatz.init_params(cfg.model, seed=t.seed, dtype=dtype,
                                        device=dev)
        params = ansatz.as_params(params, dtype, dev)
        self.device, self.dtype = dev, dtype
        self.layout = _Layout(params, frozen)
        self.flat = self.layout.flat(params, dtype, dev).requires_grad_(True)
        self.opt = make_optimizer(cfg, self.flat)
        self.sched_count = 0
        if opt_state is not None:
            self.sched_count = _restore_opt(cfg, self.opt, self.layout,
                                            opt_state)
        self.loss_dtype = torch.promote_types(dtype, torch.float32)
        self.best_loss = torch.full((), float("inf") if best_loss is None
                                    else float(best_loss),
                                    dtype=self.loss_dtype, device=dev)
        self.best_flat = (self.flat.detach().clone() if best_params is None
                          else self.layout.flat(best_params, dtype, dev))
        self.ema_flat = (self.flat.detach().clone() if ema_params is None
                         else self.layout.flat(ema_params, dtype, dev))
        # the last step's History: (l_tot, l_pde, l_bc, E) in the loss type
        self.row = torch.zeros(4, dtype=self.loss_dtype, device=dev)
        self.step = int(start_step)
        self._batch = None
        self.batch = batch
        self.generator = generator
        self.capture = graphs.captures(dev, mesh, graph)
        self._step = graphs.StepGraph(self._train_step, self.capture)
        self._sampler = None    # (sample callable, its StepGraph)
        self._drew = False      # whether the last step resampled

    @property
    def batch(self) -> Optional[Batch]:
        """The static batch the steps train on (None until one is set);
        assigning a batch copies it into this one."""
        return self._batch

    @batch.setter
    def batch(self, batch: Optional[Batch]) -> None:
        if batch is not None:
            self._batch = graphs.keep(self._batch, batch)

    def advance(self, sample: Callable[[torch.Generator], Batch]) -> History:
        """One Adam step: a fresh ``sample(generator)`` first when the
        schedule resamples (every ``resample_every`` steps while ``step <
        resample_frac * epochs``). Returns the step's history: views of
        ``row`` (on the device, overwritten by the next step; the loss is
        that of the params before the update)."""
        with profiling.annotate("advance", self.step):
            t = self.cfg.train
            self._drew = self.step % t.resample_every == 0 and \
                self.step < int(t.resample_frac * t.epochs)
            if self._drew:
                if self._sampler is None or self._sampler[0] is not sample:
                    def draw():
                        profiling.mark("sample")
                        self.batch = sample(self.generator)
                    self._sampler = (sample, graphs.StepGraph(
                        draw, self.capture, generators=(self.generator,)))
                with profiling.annotate("resample"):
                    self._sampler[1]()
            self.opt.set_lr(learning_rate(self.cfg, self.sched_count))
            with profiling.annotate("step"):
                self._step()
            self.sched_count += 1
            self.step += 1
        return History(*self.row)

    def phases(self) -> dict:
        """{phase: device ms} of the last step while tracing is on (else
        {}): ``sample`` if it resampled, then ``forward`` (the loss),
        ``backward`` and ``update`` (best, history row, Adam, EMA)."""
        out = self._sampler[1].phases() if self._drew else {}
        return {**out, **self._step.phases()}

    def _train_step(self) -> None:
        """The step on the static buffers: loss and gradient, best, history
        row, Adam, EMA."""
        cfg, m = self.cfg, self.mesh
        self.flat.grad = None
        profiling.mark("forward")
        l_tot, aux = self.loss(self.layout.tree(self.flat), cfg, self.batch,
                               allreduce=None if m is None else m.sum)
        e_last = aux.e_last
        profiling.mark("backward")
        if m is None:
            l_tot.backward()
        else:
            (l_tot / m.size).backward()
            m.sum_grads([self.flat])
            # E of the global last point: the last rank's last point
            e_last = m.sum(torch.where(
                torch.tensor(m.rank == m.size - 1, device=self.device),
                e_last.detach(), torch.zeros_like(e_last)))
        profiling.mark("update")
        with torch.no_grad():
            improved = l_tot < self.best_loss
            self.best_flat.copy_(torch.where(improved, self.flat,
                                             self.best_flat))
            self.best_loss.copy_(torch.where(
                improved, l_tot.to(self.loss_dtype), self.best_loss))
            self.row.copy_(torch.stack((l_tot, aux.l_pde, aux.l_bc,
                                        e_last)))
        self.opt.step(self.flat.grad)
        with torch.no_grad():
            d = cfg.train.ema_decay
            self.ema_flat.copy_(d * self.ema_flat + (1.0 - d) * self.flat)

    def state(self) -> TrainState:
        """The run's state; its tensors are views of the live buffers (copy
        what must outlive the next step)."""
        lay = self.layout
        return TrainState(
            self.step, lay.tree(self.flat.detach()),
            None if lay.frozen else _opt_tree(self.cfg, self.opt, lay,
                                              self.sched_count),
            self.batch, lay.tree(self.best_flat), self.best_loss,
            lay.tree(self.ema_flat), self.generator)


def train(cfg: Config,
          params: Optional[dict] = None,
          opt_state=None,
          start_step: int = 0,
          frozen: frozenset = frozenset(),
          checkpoint_cb: Optional[Callable[[TrainState, int], None]] = None,
          log_cb: Optional[Callable[[int, dict], None]] = None,
          mesh=None,
          batch: Optional[Batch] = None,
          device="cuda", graph: bool = True) -> TrainResult:
    """Run the training schedule on ``device`` (with ``mesh``: on every
    rank of it, each on its own device).

    ``cfg.train.epochs`` is the TOTAL schedule length: resuming with
    ``start_step = s`` runs the remaining ``epochs - s`` steps, so the
    resample cutoff, the best-persist gate and the step counter share one
    absolute counter. ``params`` None draws the seeded init
    (``cfg.train.seed``); ``opt_state`` is an Adam state in the JAX layout
    (a state.npz's "opt" tree). The host reads the device every
    ``scan_chunk`` steps: ``log_cb(step, metrics)`` (with tracing on, also
    the last step's ``<phase>_ms``: ``Trainer.phases``) and, past the
    persist gate and on a new best, ``checkpoint_cb(state, step)``. ``batch``:
    the first (global) batch, trained on until the schedule resamples
    (default: drawn from the generator).

    ``mesh`` (``parallel.mesh.Mesh``) shards the batch over the ranks as
    the JAX package's GSPMD path does: every rank draws the same global
    batch from the same generator and keeps its block
    (``parallel.mesh.shard_batch``), so the run equals the unsharded one up
    to the order of the all-reduced sums (bit for bit at world size 1).
    Only rank 0 calls ``log_cb`` and ``checkpoint_cb``.

    ``graph``: capture the step on a CUDA device without a mesh (the
    default; ``Trainer``); False runs it eagerly."""
    t = cfg.train
    dev = mesh.device if mesh is not None else resolve_device(device)
    tr = Trainer(cfg, params, opt_state=opt_state, start_step=start_step,
                 frozen=frozen, mesh=mesh, device=dev, graph=graph,
                 generator=torch.Generator(device=dev).manual_seed(
                     int(t.seed)))

    def block(batch):
        return batch if mesh is None else shard_batch(batch, mesh)

    def sample(gen):
        return block(sample_batch(gen, cfg, device=dev))

    tr.batch = sample(tr.generator) if batch is None else \
        block(Batch(*(a.to(dev) for a in batch)))
    coordinator = mesh is None or mesh.is_coordinator
    chunks = []
    n_done = start_step
    persist_after = int(t.best_after_frac * t.epochs)
    last_persisted_best = np.inf
    t0 = time.perf_counter()
    while n_done < t.epochs:
        n = min(t.scan_chunk, t.epochs - n_done)
        # the history in the loss type (numpy has no bfloat16: a bfloat16
        # run's rows widen exactly to float32)
        hist = torch.empty((n, 4), dtype=tr.loss_dtype, device=dev)
        for j in range(n):
            tr.advance(sample)
            hist[j].copy_(tr.row)
        n_done += n
        with profiling.annotate("read"):
            chunks.append(hist.cpu().numpy())
            best = float(tr.best_loss)
        if log_cb is not None and coordinator:
            last = chunks[-1][-1]
            rec = {"Ltot": float(last[0]), "Lpde": float(last[1]),
                   "Lbc": float(last[2]), "E": float(last[3]), "best": best}
            if profiling.enabled():
                rec.update({f"{k}_ms": v for k, v in tr.phases().items()})
            log_cb(n_done, rec)
        if (checkpoint_cb is not None and coordinator
                and n_done > persist_after and best < last_persisted_best):
            checkpoint_cb(tr.state(), n_done)
            last_persisted_best = best
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    runtime = time.perf_counter() - t0
    steps_run = n_done - start_step
    h = np.concatenate(chunks) if chunks else np.zeros((0, 4), np.float32)
    history = {"Ltot": h[:, 0], "Lpde": h[:, 1], "Lbc": h[:, 2],
               "Energy": h[:, 3]}
    state = tr.state()
    return TrainResult(
        state=state,
        params=ansatz.to_numpy_params(state.params),
        best_params=ansatz.to_numpy_params(state.best_params),
        best_loss=float(tr.best_loss),
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
