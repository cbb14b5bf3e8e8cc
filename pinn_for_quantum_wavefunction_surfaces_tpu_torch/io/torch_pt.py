"""The reference's ``.pt`` checkpoints, read and written with torch.

The reference saves ``{"model_state_dict", "optimizer_state_dict"}`` of its
``NN_ion`` module. The state dict maps to the symmetric family's param tree
as the JAX package's ``io/torch_pt.py`` maps it: torch's Linear stores its
weight (out, in), the param tree (in, out). Files are read with
``torch.load(weights_only=True)``, which unpickles tensors and plain
containers only.
"""

from __future__ import annotations

import numpy as np
import torch

# reference NN_ion state-dict names -> param-tree names
_STATE_DICT_MAP = {
    "Lin_H1": "h1", "Lin_H2": "h2", "Lin_out": "out",
    "Lin_E1": "e1", "Lin_E2": "e2", "Lin_Eout": "eout",
    "netDecayL": "gate1", "netDecay": "gate2",
}


def state_dict_to_params(state_dict: dict) -> dict:
    """The param tree (numpy arrays) of an NN_ion state dict."""
    params: dict = {}
    for torch_name, ours in _STATE_DICT_MAP.items():
        w = np.asarray(torch.as_tensor(state_dict[f"{torch_name}.weight"]))
        b = np.asarray(torch.as_tensor(state_dict[f"{torch_name}.bias"]))
        params[ours] = {"w": w.T.copy(), "b": b.copy()}
    return params


def params_to_state_dict(params: dict) -> dict:
    """The NN_ion state dict (torch tensors on the CPU) of a param tree of
    numpy arrays or tensors."""
    def tensor(a):
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().clone()
        return torch.tensor(np.asarray(a))

    sd = {}
    for torch_name, ours in _STATE_DICT_MAP.items():
        sd[f"{torch_name}.weight"] = tensor(params[ours]["w"]).T.contiguous()
        sd[f"{torch_name}.bias"] = tensor(params[ours]["b"])
    return sd


def load_reference_checkpoint(path: str) -> dict:
    """The param tree (numpy arrays) of a reference ``.pt`` checkpoint."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    return state_dict_to_params(ck["model_state_dict"])


def save_reference_checkpoint(path: str, params: dict) -> None:
    """Write a ``.pt`` checkpoint the reference's ``loadModel`` reads."""
    torch.save({"model_state_dict": params_to_state_dict(params),
                "optimizer_state_dict": {}}, path)
