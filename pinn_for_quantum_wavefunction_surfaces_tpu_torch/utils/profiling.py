"""The port's tracing: host spans and device phase marks, off by default.

- :func:`enable` / :func:`enabled`: the switch, one module flag. While it
  is off, a span is a shared no-op and a mark returns at once.
- :func:`trace` records a region with ``torch.profiler`` (host and, where
  CUDA is available, device activity) with tracing on, and writes a Chrome
  trace into ``logdir`` (viewable in Perfetto or chrome://tracing);
- :func:`annotate` is a span: ``torch.profiler.record_function`` named
  ``pinn.<name>``, so the profiler records it on the clock of its device
  rows. The trainers open ``pinn.advance`` around a step (its ``args``: the
  step number), ``pinn.resample`` and ``pinn.step`` around the calls of
  their step graphs inside it, ``pinn.capture`` around a capture, and
  ``pinn.read`` around a chunk's read of the device;
- :func:`mark` opens a phase of the step being recorded
  (``training/graphs.StepGraph`` records each call it runs as Python: the
  eager call and the capture, never a replay), closing the phase before
  it. On a host with CUDA a mark is a timing event on the current stream,
  which a capture turns into an event-record node of the graph, so every
  replay times its phases again; without CUDA it reads the host clock (CPU
  ops are synchronous). :func:`phase_ms` turns one recorded call's marks
  into {phase: ms}. The step's first mark opens its first phase.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_NAME = "trace.json"
SPAN = "pinn."

_on = False
_marks = None        # the marks of the step call being recorded, or None
_OFF = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    """Turn tracing on (or off)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed region, tracing on,
    into ``logdir``/trace.json."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = _on
    enable(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        enable(was)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_NAME))


def annotate(name: str, args=None):
    """The span ``pinn.<name>`` while tracing is on (``args``, if given, as
    its string); a shared no-op context while it is off."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(
        SPAN + name, None if args is None else str(args))


def _stamp():
    if torch.cuda.is_available():
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        return event
    return time.perf_counter()


def mark(name: str) -> None:
    """Open phase ``name`` of the step call being recorded, closing the one
    before it; nothing while tracing is off or no call is recorded."""
    if _marks is not None:
        _marks.append((name, _stamp()))


@contextlib.contextmanager
def recording():
    """The marks of the enclosed step call: yields their list, closed by a
    last mark (named None) when the call returns, while tracing is on;
    yields None while it is off."""
    global _marks
    if not _on:
        yield None
        return
    outer, marks = _marks, []
    _marks = marks
    try:
        yield marks
        marks.append((None, _stamp()))
    finally:
        _marks = outer


def phase_ms(marks) -> dict:
    """{phase: ms} of one recorded call's marks, each from its mark to the
    next (a phase marked twice adds up); waits on the last mark only. {}
    for None or no marks."""
    if not marks:
        return {}
    last = marks[-1][1]
    timed = isinstance(last, torch.cuda.Event)
    if timed:
        last.synchronize()
    out = {}
    for (name, a), (_, b) in zip(marks, marks[1:]):
        ms = a.elapsed_time(b) if timed else (b - a) * 1e3
        out[name] = out.get(name, 0.0) + ms
    return out
