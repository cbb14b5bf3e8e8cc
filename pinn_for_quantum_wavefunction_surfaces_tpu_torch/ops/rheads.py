"""The R-only heads of the symmetric family at every point, as one kernel
pair: E(R), alpha(R), the GZ exponent b(R) and the gate g(R) at each
point's own R (``rheads_fwd``) and their adjoint (``rheads_bwd``).

The flat-points entry (``routing.psi_lap`` -> ``pallas_train.psi_lap_train``)
meets a fresh R at every point, so the heads cannot be evaluated once an R
row as ``routing.psi_lap_rows`` does. Run as torch operations they write
and read several (n, He) tensors a step; the kernels keep those in
registers and shared memory and read R and write four values a point
(``csrc/rheads.cuh``, built into K2's libraries ``train_fwd`` and
``train_bwd``). The JAX package has no kernel here: it leaves the heads to
XLA beside its K2 call.

``RHeadsKernel`` (a ``torch.autograd.Function``) dispatches on the device
of R (``_cuda.as_built``): CUDA tensors launch the kernels (or the call
raises), CPU tensors take the plain versions, which are the torch heads of
``models/ansatz.py`` themselves (``rheads_plain``) and autograd through
them (``rheads_vjp_plain``). There is no fallback between the two.
"""

from __future__ import annotations

import torch

from ..models import ansatz
from . import _cuda

# launch counts of the pair, each bfloat16 build (``_bf16``) apart. Kept out
# of the K1/K2/K3 ``launches`` dicts (a step's kernel launches count those
# alone); ``routing.COUNTERS`` holds it, so a replayed graph adds it back.
launches = {k + sfx: 0 for sfx in ("", "_bf16")
            for k in ("rheads_fwd", "rheads_bwd")}

# the heads in the packed order (csrc/rheads.cuh): E, the gate, then alpha
# and beta where the params hold them; each layer's weight, then its bias
E_LAYERS = ("e1", "e2", "eout")
GATE_LAYERS = ("gate1", "gate2")
ALPHA_LAYERS = ("alpha1", "alpha2")
BETA_LAYERS = ("beta1", "beta2")
# the widest rank-1 head (gate, alpha, beta) the kernels take
MAX_HEAD_WIDTH = 256
POINTS_PER_TILE = 128   # csrc/rheads.cuh kThreads, in every type


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _layers(has_alpha: bool, has_beta: bool) -> tuple:
    return (E_LAYERS + GATE_LAYERS + (ALPHA_LAYERS if has_alpha else ())
            + (BETA_LAYERS if has_beta else ()))


def head_weights(params: dict, dtype) -> tuple:
    """The heads' weights and biases from a params tree, in the packed
    order, cast to the point dtype (the params' own tensors where the dtype
    agrees, so gradients reach them)."""
    names = _layers("alpha1" in params, "beta1" in params)
    return tuple(params[k][f].to(dtype) for k in names for f in ("w", "b"))


def _tree(weights, has_alpha: bool, has_beta: bool) -> dict:
    names = _layers(has_alpha, has_beta)
    return {k: {"w": weights[2 * i], "b": weights[2 * i + 1]}
            for i, k in enumerate(names)}


def widths(weights, has_alpha: bool, has_beta: bool) -> tuple:
    """(He, Hg, Ha, Hb) of the packed weights; 0 for an absent head."""
    he, hg = weights[0].shape[1], weights[6].shape[1]
    ha = weights[10].shape[1] if has_alpha else 0
    hb = weights[10 + 4 * has_alpha].shape[1] if has_beta else 0
    return he, hg, ha, hb


def weight_shapes(he: int, hg: int, ha: int, hb: int) -> tuple:
    """Shapes of the packed weights at these widths (0: no such head)."""
    def rank1(h):
        return ((1, h), (h,), (h, 1), (1,)) if h else ()

    return (((1, he), (he,), (he, he), (he,), (he, 1), (1,)) + rank1(hg)
            + rank1(ha) + rank1(hb))


# ---------------------------------------------------------------------------
# Plain versions: the torch heads


def rheads_plain(weights, r, *, p_sym: int, has_alpha: bool,
                 has_beta: bool):
    """(E, alpha, b, gate) at the R values ``r``: ``ansatz.energy`` and the
    heads ``pallas_train.train_heads`` evaluates, on the packed weights."""
    params = _tree(weights, has_alpha, has_beta)
    a = ansatz.orbital_exponent(params, r)
    return (ansatz.energy(params, r), a,
            ansatz.gz_exponent(params, r, p_sym, a), ansatz.gate(params, r))


def rheads_vjp_plain(weights, r, de, da, db, dg, *, p_sym: int,
                     has_alpha: bool, has_beta: bool, r_grad: bool):
    """(weight gradients, dr) of ``rheads_plain`` for the output cotangents
    (de, da, db, dg), each None for zero: torch autograd through the heads.
    dr is None unless ``r_grad``."""
    with torch.enable_grad():
        ws = [w.detach().requires_grad_(True) for w in weights]
        rr = r.detach().requires_grad_(r_grad)
        outs = rheads_plain(ws, rr, p_sym=p_sym, has_alpha=has_alpha,
                            has_beta=has_beta)
        pairs = [(o, c) for o, c in zip(outs, (de, da, db, dg))
                 if c is not None and o.requires_grad]
        wrt = ws + ([rr] if r_grad else [])
        grads = (torch.autograd.grad([o for o, _ in pairs], wrt,
                                     [c for _, c in pairs], allow_unused=True)
                 if pairs else [None] * len(wrt))
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, wrt)]
    return tuple(grads[:len(ws)]), (grads[-1] if r_grad else None)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/rheads.cuh in train_fwd.cu and train_bwd.cu)


def _lib(entry: str):
    """The K2 library that holds ``entry`` (``rheads_fwd`` in train_fwd,
    ``rheads_bwd`` in train_bwd), its entry points typed: pointers, then
    (n, He, psym) and the extra ints (the backward's grid first, then Hg,
    Ha, Hb), no doubles."""
    fwd = entry == "rheads_fwd"
    return _cuda.typed_lib("train_fwd" if fwd else "train_bwd",
                           6 if fwd else 8, "train",
                           n_extra_int=3 if fwd else 4, entry=entry,
                           n_double=0)


def _checked(weights, r, has_alpha, has_beta, cots=()):
    he, hg, ha, hb = widths(weights, has_alpha, has_beta)
    for h in (hg, ha, hb):
        if h > MAX_HEAD_WIDTH:
            raise ValueError(f"a head of {h} units: the R-heads kernels take "
                             f"at most {MAX_HEAD_WIDTH}")
    _cuda.check_inputs(he, weights, weight_shapes(he, hg, ha, hb),
                       (r,) + tuple(c for c in cots if c is not None))
    return he, hg, ha, hb


def rheads_fwd_cuda(weights, r, *, p_sym: int, has_alpha: bool,
                    has_beta: bool):
    """The heads on the card: (E, alpha, b, gate) for a CUDA tensor ``r``
    (float32, float64, or bfloat16 through the bfloat16 build)."""
    he, hg, ha, hb = _checked(weights, r, has_alpha, has_beta)
    r = r.contiguous()
    outs = tuple(torch.empty_like(r) for _ in range(4))
    _cuda.call(_lib("rheads_fwd"), "rheads_fwd", r.dtype, r.device,
               (r, _cuda.pack(weights), *outs), (r.shape[0], he, p_sym, hg,
                                                  ha, hb))
    launches[_cuda.launch_key("rheads_fwd", r.dtype)] += 1
    return outs


def rheads_bwd_cuda(weights, r, de, da, db, dg, *, p_sym: int,
                    has_alpha: bool, has_beta: bool, r_grad: bool):
    """The heads' adjoint on the card: (weight gradients, dr), dr None
    unless ``r_grad``. Each block writes one row of partial weight
    gradients; the rows are summed here in their fixed order
    (``_cuda.weight_grads``), so two launches agree bit for bit."""
    cots = (de, da, db, dg)
    he, hg, ha, hb = _checked(weights, r, has_alpha, has_beta, cots)
    r = r.contiguous()
    cots = tuple(None if c is None else c.contiguous() for c in cots)
    n, dtype = r.shape[0], r.dtype
    grid = _cuda.grid_blocks(n, POINTS_PER_TILE, dtype)
    shapes = weight_shapes(he, hg, ha, hb)
    partials = _cuda.partial_rows(grid, shapes, r)
    dr = torch.empty_like(r) if r_grad else None
    _cuda.call(_lib("rheads_bwd"), "rheads_bwd", dtype, r.device,
               (r, _cuda.pack(weights), *cots, partials, dr),
               (n, he, p_sym, grid, hg, ha, hb))
    launches[_cuda.launch_key("rheads_bwd", dtype)] += 1
    return _cuda.weight_grads(partials, shapes, dtype), dr


# ---------------------------------------------------------------------------
# autograd.Function and the entry point


class RHeadsKernel(torch.autograd.Function):
    """(E, alpha, b, gate) = heads(r; weights) with the hand-written
    backward. cfg = (p_sym, has_alpha, has_beta). Gradients flow to the
    weights, and to r where r needs one."""

    @staticmethod
    def forward(ctx, cfg, r, *weights):
        p_sym, has_alpha, has_beta = cfg
        ctx.cfg = cfg
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, *weights)
        outs = _cuda.as_built(rheads_fwd_cuda, rheads_plain, weights, r,
                              p_sym=p_sym, has_alpha=has_alpha,
                              has_beta=has_beta)
        # an output whose inputs need no gradient is a constant, as the
        # torch heads' would be (the fine-tune trains E alone: K2's inputs
        # a, b, g stay constants and K2's backward never runs)
        needs = ctx.needs_input_grad[1:]
        e_, g_, a_, b_ = (needs[0] or any(needs[1 + i:1 + j]) for i, j in
                          ((0, 6), (6, 10), (10, 10 + 4 * has_alpha),
                           (10 + 4 * has_alpha, len(weights))))
        b_ = b_ or (a_ and p_sym < 0)
        ctx.mark_non_differentiable(*(o for o, d in zip(
            outs, (e_, a_, b_, g_)) if not d))
        return outs

    @staticmethod
    def backward(ctx, de, da, db, dg):
        r, *weights = ctx.saved_tensors
        p_sym, has_alpha, has_beta = ctx.cfg
        dws, dr = _cuda.as_built(
            rheads_bwd_cuda, rheads_vjp_plain, weights, r, de, da, db, dg,
            p_sym=p_sym, has_alpha=has_alpha, has_beta=has_beta,
            r_grad=ctx.needs_input_grad[1])
        return (None, dr) + tuple(dws)


def r_heads(params: dict, mcfg, r) -> tuple:
    """(E, alpha, b, gate) at each of the R values ``r`` through
    RHeadsKernel, differentiable in the params (and in r where it needs a
    gradient): the values of ``ansatz.energy`` and
    ``pallas_train.train_heads``."""
    cfg = (int(mcfg.inversion_symmetry), "alpha1" in params,
           "beta1" in params)
    return RHeadsKernel.apply(cfg, r, *head_weights(params, r.dtype))
