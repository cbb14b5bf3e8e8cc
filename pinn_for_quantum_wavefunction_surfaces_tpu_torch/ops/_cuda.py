"""What the CUDA kernel wrappers share: input checks, pointers, weight
packing and the typed ctypes entry points of a built library.

Each kernel library (``ops/_build.py``) exports ``<name>_f32`` and
``<name>_f64`` with a plain C interface (device pointers, then ints, then
doubles, then the stream) returning ``cudaGetLastError()`` of the launch,
and an ``<prefix>_error_string`` that names such an error.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# the widths every kernel is instantiated for (template parameter H)
SUPPORTED_HIDDEN = (4, 8, 16, 32)
MAX_POINTS = 2 ** 31 - 1024   # point index blockIdx.x * blockDim.x + tid


def check_inputs(hidden, ws, shapes, pts):
    """Raise unless the kernel takes these inputs: a supported width, CUDA
    tensors of one float32/float64 dtype on one device, (n,) point arrays
    with 32-bit indices, weights of the given shapes."""
    if hidden not in SUPPORTED_HIDDEN:
        raise ValueError(f"hidden={hidden}: the CUDA kernels are built for "
                         f"H in {SUPPORTED_HIDDEN}")
    ref = pts[0]
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"CUDA kernels take float32/float64, got {ref.dtype}")
    for t in tuple(pts) + tuple(ws):
        if not t.is_cuda or t.device != ref.device:
            raise ValueError("all kernel inputs must be CUDA tensors on one "
                             "device")
        if t.dtype != ref.dtype:
            raise TypeError("kernel inputs must share one dtype")
    for t in pts:
        if t.shape != ref.shape or t.ndim != 1:
            raise ValueError("point arrays must all be (n,)")
    if ref.shape[0] > MAX_POINTS:
        raise ValueError(f"{ref.shape[0]} points: the kernels index points "
                         f"with 32-bit ints, at most {MAX_POINTS}")
    for t, shape in zip(ws, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"weight shape {tuple(t.shape)} != {shape}")


def suffix(dtype) -> str:
    return "f64" if dtype == torch.float64 else "f32"


def ptr(t):
    """A tensor's device pointer; None is the null pointer (an output the
    kernel does not write)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def pack(ws):
    """The weights as one contiguous vector, in the order given (the
    kernels' packed layout)."""
    return torch.cat([w.reshape(-1) for w in ws]).contiguous()


def typed_lib(name: str, n_ptr: int, error_prefix: str,
              extra: tuple = (), n_extra_int: int = 0) -> ctypes.CDLL:
    """The library of kernel ``name`` with the argument types of its two
    entry points set: ``n_ptr`` pointers, (n, hidden, psym) ints and
    ``n_extra_int`` more, (ry, rz) doubles and the stream. ``extra`` names
    int-returning functions of no arguments."""
    lib = _build.load(name)
    if not getattr(lib, "_port_typed", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{sfx}")
            fn.argtypes = ([vp] * n_ptr + [ci] * (3 + n_extra_int)
                           + [cd, cd, vp])
            fn.restype = ci
        err = getattr(lib, f"{error_prefix}_error_string")
        err.argtypes = [ci]
        err.restype = ctypes.c_char_p
        for fname in extra:
            getattr(lib, fname).argtypes = []
            getattr(lib, fname).restype = ci
        lib._port_name, lib._port_error = name, err
        lib._port_typed = True
    return lib


def tiled_lib(name: str, n_ptr: int, error_prefix: str, points_per_tile,
              n_extra_int: int = 0) -> ctypes.CDLL:
    """``typed_lib`` of a kernel that works in tiles, its
    ``<name>_points_per_tile(hidden, f64)`` checked once against the
    wrapper's ``points_per_tile(hidden, dtype)`` at every width and type
    (the wrapper sizes grids and partials from it), and the argument types
    of ``<name>_occupancy(hidden, f64, int* smem_bytes)`` set, and of
    ``<name>_pg_occupancy`` (the point-gradient instantiations of a
    backward kernel) where the library has it."""
    lib = typed_lib(name, n_ptr, error_prefix, n_extra_int=n_extra_int)
    if not getattr(lib, "_tiles_checked", False):
        ci = ctypes.c_int
        tile = getattr(lib, f"{name}_points_per_tile")
        tile.argtypes, tile.restype = [ci, ci], ci
        for fname in (f"{name}_occupancy", f"{name}_pg_occupancy"):
            if hasattr(lib, fname):
                occ = getattr(lib, fname)
                occ.argtypes, occ.restype = [ci, ci, ctypes.POINTER(ci)], ci
        for h in SUPPORTED_HIDDEN:
            for dt in (torch.float64, torch.float32):
                got = tile(h, int(dt == torch.float64))
                if got != points_per_tile(h, dt):
                    raise RuntimeError(
                        f"{name}: {got} points a tile at H={h} {dt}, the "
                        f"wrapper assumes {points_per_tile(h, dt)}")
        lib._tiles_checked = True
    return lib


def occupancy(lib, hidden: int, dtype,
              point_grads: bool = False) -> tuple[int, int]:
    """(resident blocks per SM, shared memory bytes per block) of a
    ``tiled_lib``'s kernel (or its point-gradient instantiation) at this
    width and dtype, from cudaOccupancyMaxActiveBlocksPerMultiprocessor on
    the current card."""
    name = lib._port_name + ("_pg" if point_grads else "")
    smem = ctypes.c_int(0)
    blocks = getattr(lib, f"{name}_occupancy")(
        hidden, int(dtype == torch.float64), ctypes.byref(smem))
    if blocks < 0:
        raise RuntimeError(f"{name}: occupancy query failed at H={hidden}")
    return blocks, smem.value


def launch(lib, dtype, device, ptrs, n, hidden, p_sym, ry, rz,
           extra_ints: tuple = ()) -> None:
    """Call the ``_f32`` or ``_f64`` entry point of a ``typed_lib`` on the
    current stream of ``device``; raise if the launch was refused."""
    name = lib._port_name
    fn = getattr(lib, f"{name}_{suffix(dtype)}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*map(ptr, ptrs), n, hidden, int(p_sym), *extra_ints,
                 float(ry), float(rz), ctypes.c_void_p(stream))
    if err:
        msg = lib._port_error(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
