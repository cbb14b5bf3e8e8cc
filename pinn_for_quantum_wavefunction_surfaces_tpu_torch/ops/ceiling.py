"""Float32 ceiling chains: the bench line's roofline denominator.

The measurement kernels of ``csrc/ceiling.cu`` (built by ``ops/_build.py``)
and their plain versions. Each element of ``x0`` seeds ``CHAINS``
independent chains, ``x + 1e-3 c`` for chain c, and runs ``iters`` loop
iterations of ``UNROLL[which]`` steps on each:

- ``"fma"``: x <- x a + b (one fused multiply-add, 2 FLOP a step);
- ``"tanh"``: x <- tanh(x a) (one transcendental a step);

and the result is the sum of the element's chains (plus b for ``"tanh"``).
``chain`` dispatches on the device of ``x0``: a CUDA tensor launches the
kernel (or the call raises), a CPU tensor takes the plain version. These
kernels replace no TPU kernel: the JAX package's bench measures the same
two chains with XLA (root ``bench.py``, ``measure_vpu_ceilings``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _cuda

CHAINS = 8
UNROLL = {"fma": 16, "tanh": 4}
# the library's ceiling_shape(which) index of each number above
_SHAPE_INDEX = {"chains": 0, "fma": 1, "tanh": 2}


def operations(n: int, iters: int, which: str) -> float:
    """Operations of one call on n elements: FLOP for ``"fma"`` (2 a
    step), transcendentals for ``"tanh"``."""
    per_step = 2.0 if which == "fma" else 1.0
    return per_step * n * CHAINS * UNROLL[which] * iters


def chain_plain(x0: torch.Tensor, iters: int, a: float, b: float,
                which: str = "fma") -> torch.Tensor:
    """The chains in plain tensor ops (multiply, then add)."""
    v = x0[:, None] + 1e-3 * torch.arange(CHAINS, dtype=x0.dtype,
                                          device=x0.device)
    for _ in range(iters * UNROLL[which]):
        v = v * a + b if which == "fma" else torch.tanh(v * a)
    s = v.sum(dim=1)
    return s if which == "fma" else s + b


def _lib() -> ctypes.CDLL:
    lib = _build.load("ceiling")
    if not getattr(lib, "_port_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for which in UNROLL:
            fn = getattr(lib, f"ceiling_{which}_f32")
            fn.argtypes = [vp, vp, ci, ci, cf, cf, vp]
            fn.restype = ci
        lib.ceiling_shape.argtypes, lib.ceiling_shape.restype = [ci], ci
        lib.ceiling_error_string.argtypes = [ci]
        lib.ceiling_error_string.restype = ctypes.c_char_p
        want = {"chains": CHAINS, **UNROLL}
        for key, idx in _SHAPE_INDEX.items():
            got = lib.ceiling_shape(idx)
            if got != want[key]:
                raise RuntimeError(f"ceiling: the library's {key} is {got}, "
                                   f"the wrapper counts {want[key]}")
        lib._port_typed = True
    return lib


def chain_cuda(x0: torch.Tensor, iters: int, a: float, b: float,
               which: str = "fma") -> torch.Tensor:
    """The chains on the card (``csrc/ceiling.cu``); raises if the kernel
    cannot be built or launched."""
    if not x0.is_cuda or x0.dtype != torch.float32 or x0.ndim != 1:
        raise ValueError("the ceiling kernels take one (n,) float32 CUDA "
                         "tensor")
    if x0.numel() > _cuda.MAX_POINTS:
        raise ValueError(f"{x0.numel()} elements: the kernels index with "
                         f"32-bit ints, at most {_cuda.MAX_POINTS}")
    x0 = x0.contiguous()
    out = torch.empty_like(x0)
    lib = _lib()
    fn = getattr(lib, f"ceiling_{which}_f32")
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ctypes.c_void_p(x0.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()), x0.numel(), int(iters),
                 float(a), float(b), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"ceiling_{which} launch failed: CUDA error {err} "
                           f"({lib.ceiling_error_string(err).decode()})")
    return out


def chain(x0: torch.Tensor, iters: int, a: float, b: float,
          which: str = "fma") -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if which not in UNROLL:
        raise ValueError(f"unknown chain {which!r}: 'fma' or 'tanh'")
    if x0.is_cuda:
        return chain_cuda(x0, iters, a, b, which)
    return chain_plain(x0, iters, a, b, which)
