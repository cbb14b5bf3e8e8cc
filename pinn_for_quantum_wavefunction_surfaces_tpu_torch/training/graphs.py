"""One training step captured once as a CUDA graph and replayed every step:
the port's counterpart of the JAX trainers' ``jax.jit`` of ``lax.scan``.

The JAX package compiles a chunk of steps into one XLA executable, and the
host reads the device only between chunks (``training/engine.py``,
``training/variational.py``). Here a step is a callable of no arguments that
reads and writes only tensors that stay where they are (its trainer's static
buffers: params, Adam's moments, best, EMA, batch, history row). A
``StepGraph`` runs the step's first call eagerly, as a real step of the run
(it loads the kernels' libraries and warms the side stream), captures the
second call on that side stream and replays it, and replays the graph from
then on. The host still reads the device only between chunks.

Draws from a ``torch.Generator`` are captured with the step: the generator
is registered with the graph (``CUDAGraph.register_generator_state``), and
each replay advances its offset as an eager call would, so a replayed run
equals the eager one bit for bit, draws included.

A trainer captures on a CUDA device without a mesh (``captures``). It stays
eager on the CPU, which only the tests ask for, and under a mesh, whose
NCCL all-reduces stay eager for now. A capture or replay error raises:
nothing falls back to the eager step.

The kernel path counts in Python (``ops/routing.COUNTERS``): the kernel
wrappers their launches, the routes their head evaluations and the points
they send to the forward-Laplacian pass. A replay passes through none of
them: what a capture records is taken off the counts, and added back once
per replay, so the counts stay exact.

Tracing (``utils/profiling.py``): each call that runs ``fn`` as Python (the
eager call, a capture, every call of an eager step) records the phase marks
``fn`` makes while tracing is on, and ``phases`` reads them after the call.
A graph holds the marks of the tracing state it was captured under: when
the state differs at a call, the graph is released and captured again, once,
so the steps of one process run without marks while tracing is off and with
them while it is on.

Python's cyclic collector is paused while a graph is captured: a trainer
and its ``StepGraph`` form a cycle, so an earlier trainer's graph is freed
by a collection, and one run inside a capture would destroy that graph
there, which ends the capture (``cudaErrorStreamCaptureInvalidated``).
torch's ``cuda.graph`` no longer collects before it captures.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable

import torch

from ..ops import routing
from ..utils import profiling


@contextlib.contextmanager
def gc_paused():
    """No cyclic collection inside the block (the collector as it was
    after)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def keep(static, value):
    """``value`` (a tensor or a tuple of them, such as a ``Batch``) written
    into the static buffer(s) ``static`` of the same shapes, which are
    returned; the first time (``static`` None) a copy of ``value`` becomes
    the buffer."""
    if static is None:
        if isinstance(value, torch.Tensor):
            return value.detach().clone()
        return type(value)(*(t.detach().clone() for t in value))
    if isinstance(value, torch.Tensor):
        static.copy_(value)
    else:
        for buf, t in zip(static, value, strict=True):
            buf.copy_(t)
    return static


def captures(device, mesh=None, graph: bool = True) -> bool:
    """Whether a trainer captures its step: with ``graph`` on a CUDA device
    without a mesh."""
    return bool(graph) and torch.device(device).type == "cuda" \
        and mesh is None


class StepGraph:
    """``fn`` (no arguments, static buffers only) as a step that is
    captured when ``capture`` is set (``captures``), else always eager.
    Calling it runs one step: eager the first time, then the replay of
    the graph captured at the second call. ``generators``: the
    ``torch.Generator``s that ``fn`` draws from."""

    def __init__(self, fn: Callable[[], None], capture: bool,
                 generators=(), counters=routing.COUNTERS):
        self.fn, self.capture = fn, capture
        self.generators = tuple(g for g in generators if g is not None)
        self.counters = counters
        self.graph = None
        self.traced = False     # the tracing state the graph holds
        self.marks = None       # the phase marks of the last recorded call
        self.warm = False
        self.per_replay = [{} for _ in counters]   # launches a replay makes
        self._stream = None

    def __call__(self) -> None:
        if not self.capture:
            self._run()
            return
        if not self.warm:
            self.eager()
            self.warm = True
            return
        if self.graph is not None and self.traced != profiling.enabled():
            self.graph = None     # the last reference: released
        if self.graph is None:
            before = [dict(c) for c in self.counters]
            self.traced = profiling.enabled()
            with profiling.annotate("capture"):
                self.graph = self.record()
            self.per_replay = [{k: c[k] - b.get(k, 0) for k in c}
                               for c, b in zip(self.counters, before)]
            for c, b in zip(self.counters, before):
                c.update(b)
        self.graph.replay()
        for c, d in zip(self.counters, self.per_replay):
            for k, v in d.items():
                c[k] += v

    def _run(self) -> None:
        """``fn``, its phase marks recorded while tracing is on."""
        with profiling.recording() as marks:
            self.fn()
        self.marks = marks

    def phases(self) -> dict:
        """{phase: device ms} of the last call ({} if it ran with tracing
        off); waits on the call's last mark only."""
        return profiling.phase_ms(self.marks)

    @property
    def stream(self) -> torch.cuda.Stream:
        """The side stream of the eager first call and of the capture."""
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def eager(self) -> None:
        """The first call: ``fn`` on the side stream that the capture will
        use, ordered after the work before it and before the work after
        it."""
        cur = torch.cuda.current_stream()
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            self._run()
        cur.wait_stream(self.stream)

    def record(self):
        """One call of ``fn`` captured as a CUDA graph on the side stream,
        with the generators registered and the cyclic collector paused.
        Capturing runs nothing: the replay that follows is the step."""
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with gc_paused(), torch.cuda.graph(graph, stream=self.stream):
            self._run()
        return graph
