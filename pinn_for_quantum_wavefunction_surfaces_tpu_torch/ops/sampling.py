"""Collocation sampling for the 4-D (x, y, z, R) training domain.

The PyTorch counterpart of ``Batch``, ``sample_batch`` and ``masked_mean``
of the JAX package's ``ops/sampling.py``. Every draw comes from an explicit
``torch.Generator`` on the batch's device, so a batch is made on the card
with no host round trip. The generators differ from ``jax.random``: the same
seed gives other points.

The boundary sets (points with r >= bc_cutoff) are fixed-shape boolean
masks with (sum, count) reductions. Points within ``cutoff`` of either
nucleus get their x coordinate set to ``cutoff``, then the radii are
recomputed before the masks are built (``clamp_and_mask``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Config
from ..device import resolve_device, resolve_dtype
from .operators import radial


class Batch(NamedTuple):
    """A fixed-shape collocation batch; all fields (n,)-shaped."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    r: torch.Tensor     # half internuclear distance per point
    bc1: torch.Tensor   # bool: r1 >= bc_cutoff (boundary-decay set 1)
    bc2: torch.Tensor   # bool: r2 >= bc_cutoff


def _uniform(gen, n, lo, hi, dtype, device):
    u = torch.rand(n, generator=gen, dtype=dtype, device=device)
    return lo + (hi - lo) * u


def clamp_and_mask(cfg: Config, x, y, z, r) -> Batch:
    """The nuclear-singularity clamp and the boundary masks: x is set to
    ``cutoff`` where either radius is inside the cutoff ball, then the
    radii are recomputed for the masks r1, r2 >= bc_cutoff."""
    dom, mcfg = cfg.domain, cfg.model
    r1, r2 = radial(mcfg, x, y, z, r)
    x = torch.where((r1 < dom.cutoff) | (r2 < dom.cutoff),
                    torch.full_like(x, dom.cutoff), x)
    r1, r2 = radial(mcfg, x, y, z, r)
    return Batch(x, y, z, r, r1 >= dom.bc_cutoff, r2 >= dom.bc_cutoff)


def sample_batch(gen: torch.Generator, cfg: Config, n: int | None = None,
                 dtype=None, device=None) -> Batch:
    """Draw n collocation points (default ``cfg.train.n_train``) with the
    clamp applied, from ``gen`` on ``device`` (default: the generator's).

    ``domain.sampler == "mixed"`` replaces the first ``focus_frac * n``
    points with exponential shells around the nuclei: radius focus_floor +
    Gamma(3, focus_scale), drawn as -focus_scale log(u1 u2 u3) from three
    uniforms of ``gen`` (torch.distributions takes no generator), an
    isotropic direction and a random nucleus."""
    dom, mcfg = cfg.domain, cfg.model
    n = cfg.train.n_train if n is None else n
    dtype = resolve_dtype(cfg.dtype if dtype is None else dtype)
    dev = resolve_device(gen.device if device is None else device)
    b = dom.box
    x, y, z = (_uniform(gen, n, -b, b, dtype, dev) for _ in range(3))
    if dom.fixed_r is not None:
        r = torch.full((n,), dom.fixed_r, dtype=dtype, device=dev)
    else:
        r = _uniform(gen, n, dom.r_lo, dom.r_hi, dtype, dev)
    if dom.sampler == "mixed":
        n_f = int(dom.focus_frac * n)
        # 1 - rand is in (0, 1]: the logarithm stays finite
        u3 = 1.0 - torch.rand((n_f, 3), generator=gen, dtype=dtype,
                              device=dev)
        u = dom.focus_floor - dom.focus_scale * torch.log(u3.prod(dim=1))
        d = torch.randn((n_f, 3), generator=gen, dtype=dtype, device=dev)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        coin = torch.rand(n_f, generator=gen, dtype=dtype, device=dev)
        sign = torch.where(coin < 0.5, 1.0, -1.0).to(dtype)
        xf = torch.clamp(sign * r[:n_f] + u * d[:, 0], -b, b)
        yf = torch.clamp(sign * mcfg.ry + u * d[:, 1], -b, b)
        zf = torch.clamp(sign * mcfg.rz + u * d[:, 2], -b, b)
        x = torch.cat([xf, x[n_f:]])
        y = torch.cat([yf, y[n_f:]])
        z = torch.cat([zf, z[n_f:]])
    return clamp_and_mask(cfg, x, y, z, r)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` over ``mask`` with a fixed shape: sum/count,
    guarded against empty masks."""
    count = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, values, 0.0).sum() / count
