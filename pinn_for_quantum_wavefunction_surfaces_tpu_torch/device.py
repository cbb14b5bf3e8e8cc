"""Device and dtype resolution shared by the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. A CUDA request
on a host without CUDA raises: nothing carries on on the CPU in its place.
"""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}
DEVICE_HELP = ("cuda (the Hopper kernels; raises without CUDA) or cpu (the "
               "plain PyTorch path)")


def resolve_device(device="cuda") -> torch.device:
    """torch.device for ``device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' (CLI: --device cpu) to run the plain "
            "PyTorch path on the CPU")
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    """torch dtype from a name ("float32", "float64", "bfloat16") or a
    torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}: the port computes in "
                         "float32, float64 or bfloat16")
    return DTYPES[dtype]
