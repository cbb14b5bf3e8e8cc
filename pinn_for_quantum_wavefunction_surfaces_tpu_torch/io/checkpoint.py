"""Native checkpoints: flat-key ``.npz`` archives with a JSON manifest.

The same layout as the JAX package's ``io/checkpoint.py``, written with
numpy alone: a single ``.npz`` whose keys are '/'-joined tree paths, plus a
``__meta__`` JSON byte string. A checkpoint saved here loads unchanged in the
JAX package's ``checkpoint.load_params``, and the other way round.

Leaves may be numpy arrays, torch tensors (on any device) or Python scalars;
trees are nested dicts, lists and tuples. A bfloat16 tensor is written as
the JAX package writes a bfloat16 array: a 2-byte void array (``V2``) of its
bits. Neither package reads such a leaf back: ``load_params`` raises on it,
naming the leaf.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

# a bfloat16 leaf as numpy holds it: 2 bytes of bits a value
BFLOAT16_BITS = np.dtype("V2")


def as_numpy(x) -> np.ndarray:
    """A leaf as the numpy array a checkpoint holds: a bfloat16 tensor as
    the 2-byte void array of its bits (numpy has no bfloat16; the JAX
    package's ``np.savez`` of an ml_dtypes bfloat16 array writes the same
    bytes)."""
    if hasattr(x, "detach"):            # a torch tensor
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BFLOAT16_BITS)
        return t.numpy()
    return np.asarray(x)


def as_tensor(a) -> torch.Tensor:
    """A host tensor of an array (or anything ``np.asarray`` takes); the
    2-byte void array of ``as_numpy`` back to its bfloat16 tensor. (A
    checkpoint's bfloat16 leaf never gets here: ``load_params`` refuses
    it.)"""
    a = np.array(a)
    if a.dtype == BFLOAT16_BITS:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(a)


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """'/'-joined paths in the JAX tree order: dict keys sorted, sequences
    by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: as_numpy(tree)}
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
    """Load a params-only checkpoint as plain nested dicts of numpy arrays.
    Raises ValueError on a bfloat16 leaf: such a checkpoint cannot be read
    back, in this package as in the JAX package (whose loader stops on the
    leaf with numpy's "No cast function available")."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        out: dict = {}
        for key in z.files:
            if key == "__meta__":
                continue
            if z[key].dtype == BFLOAT16_BITS:
                raise ValueError(
                    f"{path}: leaf {key!r} is bfloat16 (2-byte raw values): "
                    "the checkpoint was written by a --dtype bfloat16 run "
                    "and cannot be read back, as in the JAX package; train "
                    "or score in float32 or float64 to get a checkpoint that "
                    "loads")
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
        return out, meta
