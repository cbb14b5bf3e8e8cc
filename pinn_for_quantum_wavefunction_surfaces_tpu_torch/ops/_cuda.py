"""What the CUDA kernel wrappers of K1, K2 and K3 share: the dispatch
between a kernel and its plain version (``as_built``), input checks,
pointers, weight packing, the typed ctypes entry points of a built library,
the launch layout (threads, tiles, grids, occupancy) and the backward
launches' rows of partial weight gradients. Each wrapper keeps what is its
own: weight shapes and packing, ``points_per_tile``, the plain versions,
the argument lists of its entry points and its ``launches`` counts.

Each kernel library (``ops/_build.py``) exports ``<name>_f32``,
``<name>_f64`` and ``<name>_bf16`` with a plain C interface (device
pointers, then ints, then doubles, then the stream) returning
``cudaGetLastError()`` of the launch, and an ``<prefix>_error_string`` that
names such an error. A bfloat16 build stores its tensors in bfloat16 and
computes in float32 (``csrc/common.cuh``); its backward's rows of partial
weight gradients are float32 (``partials_dtype``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# the widths every kernel is instantiated for (template parameter H)
SUPPORTED_HIDDEN = (4, 8, 16, 32)
MAX_POINTS = 2 ** 31 - 1024   # point index blockIdx.x * blockDim.x + tid
# the storage types a kernel is built for: entry point suffix and the type
# code of the libraries' queries (csrc/common.cuh kern::TypeCode)
SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
TYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

# The kernels' work layout by type: float64 blocks of 256 threads walk
# tiles (their H x H products on the tensor cores); float32 blocks of 128
# threads take one point a thread, and bfloat16 runs the float32 kernels on
# bfloat16 tensors. Each wrapper's ``points_per_tile(hidden, dtype)`` says
# how many points a tile holds. A backward kernel's grid is capped at the
# resident blocks per SM its __launch_bounds__ asks for times the H100's
# 132 SMs, so one wave.
GRID_BLOCKS_PER_SM = {torch.float64: 2, torch.float32: 3, torch.bfloat16: 3}
N_SM = 132


def threads(dtype) -> int:
    """Threads a block of any kernel: 256 on float64 tiles, 128 in float32
    and bfloat16."""
    return 256 if dtype == torch.float64 else 128


def n_tiles(n: int, per: int) -> int:
    """Tiles of ``per`` points (the wrapper's ``points_per_tile``) that
    hold n points; the last one is padded."""
    return -(-n // per)


def grid_blocks(n: int, per: int, dtype) -> int:
    """Blocks of a backward launch on tiles of ``per`` points: one a tile,
    at most GRID_BLOCKS_PER_SM * N_SM; each block walks the tiles blockIdx,
    blockIdx + grid, ... in order. The count depends on n, the tile and the
    dtype alone, so the rows of partial weight gradients (one a block),
    their order, and so the bits do too. A forward kernel sums nothing
    across points and takes one block a tile."""
    return max(1, min(n_tiles(n, per), GRID_BLOCKS_PER_SM[dtype] * N_SM))


def check_inputs(hidden, ws, shapes, pts):
    """Raise unless the kernel takes these inputs: a supported width, CUDA
    tensors of one float32/float64/bfloat16 dtype on one device, (n,) point
    arrays with 32-bit indices, weights of the given shapes."""
    if hidden not in SUPPORTED_HIDDEN:
        raise ValueError(f"hidden={hidden}: the CUDA kernels are built for "
                         f"H in {SUPPORTED_HIDDEN}")
    ref = pts[0]
    if ref.dtype not in SUFFIX:
        raise TypeError(f"CUDA kernels take float32/float64/bfloat16, got "
                        f"{ref.dtype}")
    for t in tuple(pts) + tuple(ws):
        if t.dtype != ref.dtype:
            raise TypeError("kernel inputs must share one dtype")
    for t in tuple(pts) + tuple(ws):
        if not t.is_cuda or t.device != ref.device:
            raise ValueError("all kernel inputs must be CUDA tensors on one "
                             "device")
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
    """The entry point suffix of a storage type."""
    return SUFFIX[dtype]


def partials_dtype(dtype) -> torch.dtype:
    """The type of a backward kernel's rows of partial weight gradients:
    the compute type (float32 for a bfloat16 build)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _map_tensors(fn, obj):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, o) for o in obj)
    return obj


def as_built(cuda, plain, *args, **kw):
    """A kernel wrapper's dispatch on the device of its tensors (the
    points, after the weights): ``cuda(*args, **kw)`` launches the kernel
    on CUDA tensors (or raises); on CPU tensors ``plain(*args, **kw)`` runs
    in the type semantics of the kernel build that would take them. On
    bfloat16 tensors that is the plain version's float32 arithmetic on
    their values, each output rounded once to bfloat16 (as the bfloat16
    builds do, csrc/common.cuh); on float32 and float64 tensors the plain
    version itself. Tensors among the keywords (the excited-state nodes)
    are widened as the points are. There is no fallback between the two."""
    if args[1].is_cuda:
        return cuda(*args, **kw)
    if args[1].dtype != torch.bfloat16:
        return plain(*args, **kw)
    out = plain(*_map_tensors(lambda t: t.float(), args),
                **{k: _map_tensors(lambda t: t.float(), v)
                   for k, v in kw.items()})
    return _map_tensors(lambda t: t.to(torch.bfloat16), out)


def launch_key(name: str, dtype) -> str:
    """The launch count a wrapper adds to: ``name``, or ``<name>_bf16`` for
    the bfloat16 build."""
    return f"{name}_bf16" if dtype == torch.bfloat16 else name


def sum_partials(partials, dtype) -> torch.Tensor:
    """The weight gradients of a backward launch: its rows of partials
    summed in their fixed order, in the partials' type, then rounded once
    to ``dtype``."""
    return partials.sum(0).to(dtype)


def partial_rows(grid: int, shapes, like) -> torch.Tensor:
    """The rows of partial weight gradients a backward launch of ``grid``
    blocks writes, one a block (no atomics), each holding the weights of
    ``shapes`` flat in order, in ``partials_dtype`` on the device of the
    point array ``like``."""
    size = sum(int(torch.Size(s).numel()) for s in shapes)
    return torch.empty((grid, size), dtype=partials_dtype(like.dtype),
                       device=like.device)


def weight_grads(partials, shapes, dtype) -> tuple:
    """The weight gradients of ``partial_rows`` after the launch:
    ``sum_partials`` of the rows, split and reshaped to ``shapes`` —
    repeatable bit for bit."""
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    return tuple(g.reshape(s) for g, s in zip(
        torch.split(sum_partials(partials, dtype), sizes), shapes))


def ptr(t):
    """A tensor's device pointer; None is the null pointer (an output the
    kernel does not write)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def pack(ws):
    """The weights as one contiguous vector, in the order given (the
    kernels' packed layout)."""
    return torch.cat([w.reshape(-1) for w in ws]).contiguous()


def typed_lib(name: str, n_ptr: int, error_prefix: str,
              n_extra_int: int = 0, entry: str | None = None,
              n_double: int = 2) -> ctypes.CDLL:
    """The library of kernel ``name`` with the argument types of the three
    entry points of ``entry`` (default: the library's own kernel, ``name``)
    set: ``n_ptr`` pointers, (n, hidden, psym) ints and ``n_extra_int``
    more, ``n_double`` doubles (the nuclei's ry, rz) and the stream."""
    lib = _build.load(name)
    entry = entry or name
    if not getattr(lib, "_port_typed", None):
        err = getattr(lib, f"{error_prefix}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib._port_name, lib._port_error = name, err
        lib._port_typed = set()
    if entry not in lib._port_typed:
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for sfx in SUFFIX.values():
            fn = getattr(lib, f"{entry}_{sfx}")
            fn.argtypes = ([vp] * n_ptr + [ci] * (3 + n_extra_int)
                           + [cd] * n_double + [vp])
            fn.restype = ci
        lib._port_typed.add(entry)
    return lib


def tiled_lib(name: str, n_ptr: int, error_prefix: str, points_per_tile,
              n_extra_int: int = 0) -> ctypes.CDLL:
    """``typed_lib`` of a kernel that works in tiles, its
    ``<name>_points_per_tile(hidden, type code)`` checked once against the
    wrapper's ``points_per_tile(hidden, dtype)`` at every width and type
    (the wrapper sizes grids and partials from it)."""
    lib = typed_lib(name, n_ptr, error_prefix, n_extra_int=n_extra_int)
    if not getattr(lib, "_tiles_checked", False):
        ci = ctypes.c_int
        tile = getattr(lib, f"{name}_points_per_tile")
        tile.argtypes, tile.restype = [ci, ci], ci
        for h in SUPPORTED_HIDDEN:
            for dt in TYPE_CODE:
                got = tile(h, TYPE_CODE[dt])
                if got != points_per_tile(h, dt):
                    raise RuntimeError(
                        f"{name}: {got} points a tile at H={h} {dt}, the "
                        f"wrapper assumes {points_per_tile(h, dt)}")
        lib._tiles_checked = True
    return lib


def occupancy(name: str, hidden: int, dtype, point_grads: bool = False,
              hidden_gate: int | None = None,
              lib: str | None = None) -> tuple[int, int]:
    """(resident blocks per SM, shared memory bytes per block) of kernel
    ``name`` at this width and dtype, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current card:
    ``<name>_occupancy(hidden, type code, int* smem)`` of its library (``lib``,
    by default ``name``), ``<name>_pg_occupancy`` for the point-gradient
    instantiation of a backward kernel, and for K3 (``residual_fwd``) and
    the R heads (``rheads_fwd``, ``rheads_bwd``) a second width
    ``hidden_gate`` after the hidden one."""
    fname = f"{name}_pg_occupancy" if point_grads else f"{name}_occupancy"
    fn = getattr(_build.load(lib or name), fname)
    ints = (hidden,) + (() if hidden_gate is None else (hidden_gate,))
    ci = ctypes.c_int
    fn.argtypes = [ci] * (len(ints) + 1) + [ctypes.POINTER(ci)]
    fn.restype = ci
    smem = ci(0)
    blocks = fn(*ints, TYPE_CODE[dtype], ctypes.byref(smem))
    if blocks < 0:
        raise RuntimeError(f"{fname}: the query failed at {ints}")
    return blocks, smem.value


def call(lib, entry: str, dtype, device, ptrs, ints, doubles=()) -> None:
    """Call the entry point ``<entry>_<suffix of dtype>`` of a ``typed_lib``
    with the pointers, ints and doubles given on the current stream of
    ``device``; raise if the launch was refused."""
    fn = getattr(lib, f"{entry}_{suffix(dtype)}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*map(ptr, ptrs), *map(int, ints), *map(float, doubles),
                 ctypes.c_void_p(stream))
    if err:
        msg = lib._port_error(err).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({msg})")


def launch(lib, dtype, device, ptrs, n, hidden, p_sym, ry, rz,
           extra_ints: tuple = ()) -> None:
    """``call`` of the library's own kernel (``_f32``, ``_f64`` or
    ``_bf16``) with (n, hidden, p_sym, *extra_ints) and (ry, rz)."""
    call(lib, lib._port_name, dtype, device, ptrs,
         (n, hidden, p_sym, *extra_ints), (ry, rz))
