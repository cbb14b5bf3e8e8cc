"""Forward-only fused (psi, lap psi) kernel of the reference-parity model (K3).

The PyTorch/CUDA counterpart of the JAX package's ``ops/pallas_residual.py``
(``psi_lap_pallas``). The reference-parity model is the symmetric family at
its defaults: fixed exponent 1, a 2-feature base and the LCAO physics part,

    psi = g(R) (b+ + P b- + ob) + e^{-r1} + P e^{-r2}

with b+- the two weight-shared sigmoid-MLP branches 2 -> H -> H -> 1 (b- at
the geometry mirrored at x -> -x), ob the output bias in the gerade sector
only, and the gate g(R) a 1 -> Hg -> 1 sigmoid MLP evaluated inside the
kernel. It serves the forward-only paths: the quadrature slabs of the E(R)
Rayleigh quotients (``analysis.energy``), 512 000 points a quotient on the
default 80^3 grid.

Two implementations of one arithmetic live here:
- ``psi_lap_residual_plain``: vectorised tensor ops (K2's plain forward with
  a = 1, b = 0 and the gate evaluated per point);
- ``csrc/residual_fwd.cu``: the Hopper kernel (CUDA C++ for sm_90a, built by
  ``ops/_build.py``): K2-fwd's kernel templates (``csrc/train_fwd.cuh``)
  with a = 1, b = 0 and the gate evaluated per point in the kernel; float64
  on tiles of 32 points (16 at H = 32) with the second layer on the tensor
  cores, float32 one thread a point, bfloat16 the float32 kernel on
  bfloat16 tensors.

``psi_lap_pallas`` dispatches on the device of its points: CUDA tensors
launch the kernel (or the call raises), CPU tensors take the plain version.
There is no fallback between the two, and no backward: inputs that would
need a gradient are refused.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda, pallas_train

# launch counts of the CUDA kernel, its bfloat16 build apart (plain
# integers: a run can show that its path went through the kernel). Only the
# CUDA wrapper adds to them.
launches = {"residual_fwd": 0, "residual_fwd_bf16": 0}

SUPPORTED_HIDDEN = _cuda.SUPPORTED_HIDDEN
# the gate's 3 Hg + 1 weights join the kernel's shared memory (6.2 KB in
# float64 at 256): the float64 tile kernel opts in past the 48 KB a block
# gets by default, and its occupancy at H = 16 falls from 4 to 3 blocks an
# SM past some Hg (occupancy() reports it)
MAX_HIDDEN_GATE = 256


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def weight_shapes(hidden: int, hidden_gate: int):
    """Shapes of the 10 kernel weights: K2's six (h1.w, h1.b, h2.w, h2.b,
    out.w, out.b) and the gate's gate1.w, gate1.b, gate2.w, gate2.b (biases
    as rows)."""
    return pallas_train.weight_shapes(hidden) + (
        (1, hidden_gate), (1, hidden_gate), (hidden_gate, 1), (1, 1))


def kernel_weights(params: dict, mcfg, dtype) -> tuple:
    """The 10 kernel weights from a params tree, cast to the point dtype.
    The output bias is a constant 0 in the ungerade sector."""
    g1, g2 = params["gate1"], params["gate2"]
    return pallas_train.kernel_weights(params, mcfg, dtype) + (
        g1["w"].to(dtype), g1["b"].reshape(1, -1).to(dtype),
        g2["w"].to(dtype), g2["b"].reshape(1, 1).to(dtype))


def psi_lap_residual_plain(weights, x, y, z, r, *, p_sym: int = 1,
                           ry: float = 0.0, rz: float = 0.0):
    """(psi, lap psi) per point, plain tensor ops. weights: the 10 tensors in
    ``weight_shapes`` order; x, y, z, r: (n,)."""
    gw1, gb1, gw2, gb2 = weights[6:]
    g = (torch.sigmoid(r[:, None] @ gw1 + gb1) @ gw2 + gb2)[:, 0]
    return pallas_train.psi_lap_train_plain(
        weights[:6], torch.ones_like(x), torch.zeros_like(x), g, x, y, z, r,
        p_sym=p_sym, ry=ry, rz=rz)


def residual_fwd_cuda(weights, x, y, z, r, *, p_sym: int = 1,
                      ry: float = 0.0, rz: float = 0.0):
    """K3 on the card: (psi, lap) for CUDA tensors (float32, float64, or
    bfloat16 through the bfloat16 build)."""
    hidden, hidden_gate = weights[0].shape[1], weights[6].shape[1]
    if not 0 < hidden_gate <= MAX_HIDDEN_GATE:
        raise ValueError(f"hidden_gate={hidden_gate}: the CUDA kernel takes "
                         f"1..{MAX_HIDDEN_GATE}")
    pts = (x, y, z, r)
    _cuda.check_inputs(hidden, weights,
                       weight_shapes(hidden, hidden_gate), pts)
    pts = [t.contiguous() for t in pts]
    psi = torch.empty_like(pts[0])
    lap = torch.empty_like(pts[0])
    _cuda.launch(_lib(), pts[0].dtype, pts[0].device,
                 (*pts, _cuda.pack(weights), psi, lap), pts[0].shape[0],
                 hidden, p_sym, ry, rz, extra_ints=(hidden_gate,))
    launches[_cuda.launch_key("residual_fwd", pts[0].dtype)] += 1
    return psi, lap


def _lib():
    """The typed library of K3, with the argument types of
    ``residual_fwd_occupancy(hidden, hidden_gate, type code, int* smem)``
    set."""
    lib = _cuda.typed_lib("residual_fwd", 7, "train", n_extra_int=1)
    occ = lib.residual_fwd_occupancy
    if occ.argtypes is None:
        ci = ctypes.c_int
        occ.argtypes, occ.restype = [ci, ci, ci, ctypes.POINTER(ci)], ci
    return lib


def threads(dtype) -> int:
    """Threads a block of K3: 256 on float64 tiles, 128 in float32 and
    bfloat16."""
    return 256 if dtype == torch.float64 else 128


def occupancy(hidden: int, hidden_gate: int, dtype) -> tuple[int, int]:
    """(resident blocks per SM, shared memory bytes per block) of K3 at
    these widths and dtype on the current card."""
    smem = ctypes.c_int(0)
    blocks = _lib().residual_fwd_occupancy(
        hidden, hidden_gate, _cuda.TYPE_CODE[dtype], ctypes.byref(smem))
    if blocks < 0:
        raise RuntimeError(f"residual_fwd: occupancy query failed at "
                           f"H={hidden}, Hg={hidden_gate}")
    return blocks, smem.value


def is_reference_parity(params: dict) -> bool:
    """Params of the model K3 implements: symmetric (h1.w with 2 rows, so
    no R input) with neither the alpha(R) nor the GZ b(R) head."""
    return ("h1" in params and params["h1"]["w"].shape[0] == 2
            and not any(k in params for k in ("alpha1", "beta1")))


def psi_lap_pallas(params: dict, mcfg, x, y, z, r):
    """(psi, lap psi) of flat point arrays through K3 (forward only).

    Raises NotImplementedError for other architectures and for models with
    alpha/GZ heads or an R input, as the JAX kernel does; raises ValueError
    for inputs that require grad while autograd records (K3 has no
    backward)."""
    if mcfg.arch != "symmetric":
        raise NotImplementedError("the K3 kernel covers the symmetric "
                                  "architecture")
    if not is_reference_parity(params):
        raise NotImplementedError(
            "the K3 kernel implements the reference-parity model (fixed "
            "exponents, 2-feature base); alpha/GZ models go through "
            "ops.pallas_train.psi_lap_train")
    ws = kernel_weights(params, mcfg, x.dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, y, z, r) + ws):
        raise ValueError("the K3 kernel has no backward: call it on inputs "
                         "that do not require grad, or under "
                         "torch.no_grad()")
    kw = dict(p_sym=int(mcfg.inversion_symmetry), ry=float(mcfg.ry),
              rz=float(mcfg.rz))
    if x.is_cuda:
        return residual_fwd_cuda(ws, x, y, z, r, **kw)
    return _cuda.plain_as_built(psi_lap_residual_plain, ws, x, y, z, r, **kw)
