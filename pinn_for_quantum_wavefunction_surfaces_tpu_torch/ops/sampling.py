"""Collocation sampling for the 4-D (x, y, z, R) training domain.

The PyTorch counterpart of the JAX package's ``ops/sampling.py``: the
collocation batch of the residual trainer (``sample_batch``, and
``sample_batch_at_r`` at a pinned R), the importance sample of the
Monte-Carlo variational trainer with its exact density
(``sample_importance``), and ``linear_axes``. Every draw comes from an
explicit ``torch.Generator`` on the batch's device, so a batch is made on
the card with no host round trip. The generators differ from
``jax.random``: the same seed gives other points.

The boundary sets (points with r >= bc_cutoff) are fixed-shape boolean
masks with (sum, count) reductions. Points within ``cutoff`` of either
nucleus get their x coordinate set to ``cutoff``, then the radii are
recomputed before the masks are built (``clamp_and_mask``).
"""

from __future__ import annotations

from typing import NamedTuple

import math

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


def sample_batch_at_r(gen: torch.Generator, cfg: Config, r_value,
                      n: int | None = None, dtype=None,
                      device=None) -> Batch:
    """Like ``sample_batch`` (uniform points) with the half-distance pinned
    to ``r_value`` (a scalar or an (n,) tensor): the per-R sweep's batch.
    The clamp and the masks use the pinned R."""
    dom = cfg.domain
    n = cfg.train.n_train if n is None else n
    dtype = resolve_dtype(cfg.dtype if dtype is None else dtype)
    dev = resolve_device(gen.device if device is None else device)
    b = dom.box
    x, y, z = (_uniform(gen, n, -b, b, dtype, dev) for _ in range(3))
    # a scalar R filled on the device (no host copy, which a CUDA graph
    # cannot capture)
    r = (r_value.to(dtype=dtype, device=dev)
         if isinstance(r_value, torch.Tensor) else
         torch.full((), float(r_value), dtype=dtype, device=dev)).expand(n)
    return clamp_and_mask(cfg, x, y, z, r)


def default_scale(cfg: Config, r):
    """The shells' Gamma(3) scale at half-distance r: focus_scale / (1 +
    0.8 e^{-2r}), the expected 1/alpha(R), so that small-R estimates keep
    a bounded variance."""
    return cfg.domain.focus_scale / (1.0 + 0.8 * torch.exp(-2.0 * r))


def importance_weights(cfg: Config, x, y, z, r, scale):
    """w = 1/q of ``sample_importance``'s mixture at points (x, y, z): q =
    (1 - ff) 1[box] / V + ff (shell_1 + shell_2) / 2, each shell the 3-D
    density pdf_u(|p - c|) / (4 pi |p - c|^2) of a Gamma(3, scale) radius
    about a nucleus. r and scale broadcast against the points."""
    dom = cfg.domain
    ff, b = dom.focus_frac, dom.box
    vol = (2.0 * b) ** 3
    r1, r2 = radial(cfg.model, x, y, z, r)

    def shell_density(rr):
        # no radius floor: the Gamma(3) shell's 3-D density is finite at
        # the nucleus, where psi^2 peaks
        pdf_u = torch.where(
            rr > 0, rr ** 2 * torch.exp(-rr / scale) / (2.0 * scale ** 3),
            0.0)
        return pdf_u / (4.0 * math.pi * rr ** 2)

    in_box = ((x.abs() <= b) & (y.abs() <= b) & (z.abs() <= b)).to(x.dtype)
    q = ((1.0 - ff) * in_box / vol
         + ff * 0.5 * (shell_density(r1) + shell_density(r2)))
    return 1.0 / q


def sample_importance(gen: torch.Generator, cfg: Config, r_value, n: int,
                      dtype=None, scale=None, antithetic: bool = False,
                      device=None):
    """Importance sample of the Rayleigh-quotient estimator at the
    half-distances ``r_value`` (a scalar, or a (k,) tensor for k rows at
    once): a mixture of the uniform box and exponential shells around the
    two nuclei, with its exact density. Returns (x, y, z, w), each (n,) or
    (k, n), with w = 1/q (``importance_weights``), so that sum(w f) / n
    estimates the integral of f over R^3.

    The first ``int(focus_frac n)`` points of a row come from the shells:
    radius u ~ Gamma(3, scale) drawn as -scale (log v1 + log v2 + log v3)
    from three uniforms in [tiny, 1) of ``gen`` (torch's gamma sampler
    takes no generator; the uniforms in float64 for every batch type), an
    isotropic direction and a random nucleus. Shell points may land
    outside the box (the quotient is an R^3 integral).
    ``antithetic``: the shell count is rounded down to an even number and
    its second half takes the partner radius -scale sum log(1 - v_i) (the
    same marginal, negatively correlated) with the first half's direction
    and nucleus."""
    dom, mcfg = cfg.domain, cfg.model
    dtype = resolve_dtype(cfg.dtype if dtype is None else dtype)
    dev = resolve_device(gen.device if device is None else device)
    r = torch.as_tensor(r_value, dtype=dtype, device=dev)
    rows = r.reshape(-1, 1)                              # (k, 1)
    k = rows.shape[0]
    scale = default_scale(cfg, rows) if scale is None else \
        torch.as_tensor(scale, dtype=dtype, device=dev).reshape(-1, 1)
    b = dom.box
    n_f = int(dom.focus_frac * n)
    x, y, z = (_uniform(gen, (k, n), -b, b, dtype, dev) for _ in range(3))
    # the radii's uniforms in float64 whatever the batch's type: a float32
    # draw of 0 (one in 2^24, a few a run at 10^6 points a step) becomes
    # tiny, whose log puts the point ~87 scale lengths out, where the
    # float32 density underflows to 0 and w = 1/q to inf (a NaN quotient)
    m = n_f // 2 if antithetic else n_f
    v = _uniform(gen, (k, m, 3), torch.finfo(torch.float64).tiny, 1.0,
                 torch.float64, dev)
    if antithetic:
        n_f = 2 * m
        u = torch.cat([-torch.log(v).sum(-1), -torch.log1p(-v).sum(-1)],
                      dim=1)
    else:
        u = -torch.log(v).sum(-1)
    u = u.to(dtype) * scale
    d = torch.randn((k, m, 3), generator=gen, dtype=dtype, device=dev)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    coin = torch.rand((k, m), generator=gen, dtype=dtype, device=dev)
    sign = torch.where(coin < 0.5, 1.0, -1.0).to(dtype)
    if antithetic:
        d, sign = torch.cat([d, d], dim=1), torch.cat([sign, sign], dim=1)
    x[:, :n_f] = sign * rows + u * d[..., 0]
    y[:, :n_f] = sign * mcfg.ry + u * d[..., 1]
    z[:, :n_f] = sign * mcfg.rz + u * d[..., 2]
    w = importance_weights(cfg, x, y, z, rows, scale)
    if r.ndim == 0:
        return x[0], y[0], z[0], w[0]
    return x, y, z, w


def linear_axes(cfg: Config, n: int | None = None, dtype=torch.float64,
                device="cuda"):
    """1-D linearly spaced axes of the test and quadrature grids: (x, y, z)
    over [-box, box] and R over [r_lo, r_hi], n points each (default
    ``cfg.train.n_train``)."""
    dom = cfg.domain
    n = cfg.train.n_train if n is None else n
    kw = dict(dtype=resolve_dtype(dtype), device=resolve_device(device))
    x = torch.linspace(-dom.box, dom.box, n, **kw)
    return x, x, x, torch.linspace(dom.r_lo, dom.r_hi, n, **kw)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` over ``mask`` with a fixed shape: sum/count,
    guarded against empty masks."""
    count = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, values, 0.0).sum() / count
