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

``psi_lap_pallas`` dispatches on the device of its points
(``_cuda.as_built``): CUDA tensors launch the kernel (or the call raises),
CPU tensors take the plain version. There is no fallback between the two,
and no backward: inputs that would need a gradient are refused.
``routing.kernel_of`` decides which models come here: forward-only calls
on the reference-parity model.
"""

from __future__ import annotations

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
# SM past some Hg (``_cuda.occupancy`` reports it)
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
    lib = _cuda.typed_lib("residual_fwd", 7, "train", n_extra_int=1)
    _cuda.launch(lib, pts[0].dtype, pts[0].device,
                 (*pts, _cuda.pack(weights), psi, lap), pts[0].shape[0],
                 hidden, p_sym, ry, rz, extra_ints=(hidden_gate,))
    launches[_cuda.launch_key("residual_fwd", pts[0].dtype)] += 1
    return psi, lap


def psi_lap_pallas(params: dict, mcfg, x, y, z, r):
    """(psi, lap psi) of flat point arrays through K3 (forward only).

    Raises NotImplementedError for the params that ``routing.kernel_of``
    does not give K3 (other families, models with alpha/GZ heads or an R
    input), as the JAX kernel does; raises ValueError for inputs that
    require grad while autograd records (K3 has no backward)."""
    from .routing import require    # routing imports this module
    require(params, mcfg, "K3")
    ws = kernel_weights(params, mcfg, x.dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, y, z, r) + ws):
        raise ValueError("the K3 kernel has no backward: call it on inputs "
                         "that do not require grad, or under "
                         "torch.no_grad()")
    kw = dict(p_sym=int(mcfg.inversion_symmetry), ry=float(mcfg.ry),
              rz=float(mcfg.rz))
    return _cuda.as_built(residual_fwd_cuda, psi_lap_residual_plain, ws, x,
                          y, z, r, **kw)
