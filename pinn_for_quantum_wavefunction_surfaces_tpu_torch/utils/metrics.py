"""Metric logging: console + JSONL persistence (``metrics.jsonl``).

A copy of the JAX package's ``utils/metrics.py``: one structured JSON line
per logged step beside the human-readable console line, and the per-epoch
history pickle ({Ltot, Lpde, Lbc, Energy})."""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Optional


class MetricLogger:
    def __init__(self, path: Optional[str] = None, every: int = 1,
                 console: bool = True):
        self.path = path
        self.every = every
        self.console = console
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def __call__(self, step: int, metrics: dict) -> None:
        if step % self.every:
            return
        rec = {"step": step, "t": round(time.time() - self._t0, 3), **metrics}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.console:
            body = " ".join(f"{k}={v:.3e}" if isinstance(v, float)
                            else f"{k}={v}" for k, v in metrics.items())
            print(f"{step:8d}: {body}", flush=True)

    def close(self) -> None:
        if self._f:
            self._f.close()


def save_history(path: str, history: dict) -> None:
    """Persist the per-epoch history ({Ltot, Lpde, Lbc, Energy})."""
    with open(path, "wb") as f:
        pickle.dump(history, f)


def load_history(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)
