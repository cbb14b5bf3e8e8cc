"""Native checkpoints: flat-key ``.npz`` archives with a JSON manifest.

The same layout as the JAX package's ``io/checkpoint.py``, written with
numpy alone: a single ``.npz`` whose keys are '/'-joined tree paths, plus a
``__meta__`` JSON byte string. A checkpoint saved here loads unchanged in the
JAX package's ``checkpoint.load_params``, and the other way round.

Leaves may be numpy arrays, torch tensors (on any device) or Python scalars;
trees are nested dicts, lists and tuples.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np


def _leaf(x) -> np.ndarray:
    if hasattr(x, "detach"):            # a torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """'/'-joined paths in the JAX tree order: dict keys sorted, sequences
    by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: _leaf(tree)}
    flat: dict[str, np.ndarray] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def save(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    """Save a tree (+ JSON-serialisable metadata) to ``path`` (.npz)."""
    flat = _flatten(tree)
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)  # atomic publish


def load_meta(path: str) -> dict:
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def load_params(path: str) -> tuple[dict, dict]:
    """Load a params-only checkpoint as plain nested dicts of numpy arrays."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        out: dict = {}
        for key in z.files:
            if key == "__meta__":
                continue
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
        return out, meta
