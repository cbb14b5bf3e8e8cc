"""L-BFGS of the deterministic polish: optax's curvature memory on torch's
strong-Wolfe line search.

The JAX package polishes with ``optax.lbfgs``, whose memory
(``optax.scale_by_lbfgs``) takes every curvature pair (s, y) and rescales
its initial inverse Hessian to y.s / y.y at every step. torch.optim.LBFGS
keeps a pair only when y.s > 1e-10, an absolute threshold. Late in a
polish an L-BFGS step lowers the quotient objective (about 1 Ha) by
1e-11 to 1e-9 Ha, so y.s falls under that threshold: torch's memory
freezes, and the flagship's descent stalled about 500 steps into its 800
(the smallest R ended 0.0113 mHa above the exact energy). This optimiser
keeps every pair with y.s > 0, as optax keeps every pair but those with
y.s == 0 (a pair with y.s < 0 would make the inverse Hessian indefinite,
and a strong-Wolfe step always has y.s > 0). The line search is torch's
strong-Wolfe search (cubic interpolation, c1 = 1e-4, c2 = 0.9), not
optax's zoom search, so the trajectories of the two packages still differ.

The objective and its gradient at the point a line search accepts are kept
and reused by the next step: one evaluation a step fewer than
torch.optim.LBFGS with ``max_iter=1``, which evaluates the point again.
"""

from __future__ import annotations

import math

import torch
from torch.optim.lbfgs import _strong_wolfe

# the line search stops when its bracket narrows below this step in x
TOLERANCE_CHANGE = 1e-12


class LBFGS:
    """L-BFGS over a list of leaf tensors with gradients: ``step(closure)``
    takes one step and returns the objective at the point it started from.
    ``closure`` evaluates the objective at the leaves' current values,
    fills their ``.grad`` and returns the objective (a tensor)."""

    def __init__(self, params, memory_size: int = 15, max_ls: int = 20):
        self.params = list(params)
        self.memory_size = memory_size
        self.max_ls = max_ls
        self.s: list[torch.Tensor] = []
        self.y: list[torch.Tensor] = []
        self.rho: list[torch.Tensor] = []
        self.gamma = None          # initial inverse-Hessian scale y.s / y.y
        self.prev = None           # (x, g) where the last step started
        self.at = None             # (x, f, g) where the last step ended

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _x(self) -> torch.Tensor:
        return torch.cat([p.detach().reshape(-1) for p in self.params])

    def _g(self) -> torch.Tensor:
        return torch.cat([torch.zeros_like(p).reshape(-1) if p.grad is None
                          else p.grad.reshape(-1) for p in self.params])

    def _set(self, x: torch.Tensor) -> None:
        i = 0
        for p in self.params:
            n = p.numel()
            p.copy_(x[i:i + n].view_as(p))
            i += n

    def _evaluate(self, closure, x: torch.Tensor):
        """(objective, flat gradient) at ``x``."""
        self._set(x)
        with torch.enable_grad():
            f = float(closure().detach())
        return f, self._g()

    def _direction(self, g: torch.Tensor) -> torch.Tensor:
        """-H g by the two-loop recursion over the memory; with no memory,
        the gradient scaled by min(1, 1 / |g|), optax's first step."""
        if not self.s:
            return -g * min(1.0, 1.0 / max(float(g.norm()), 1e-300))
        q = -g
        alpha = []
        for s, y, rho in zip(reversed(self.s), reversed(self.y),
                             reversed(self.rho)):
            a = rho * s.dot(q)
            q = q - a * y
            alpha.append(a)
        r = q * self.gamma
        for s, y, rho, a in zip(self.s, self.y, self.rho, reversed(alpha)):
            r = r + (a - rho * y.dot(r)) * s
        return r

    @torch.no_grad()
    def step(self, closure) -> float:
        x = self._x()
        if self.at is not None and torch.equal(self.at[0], x):
            _, f, g = self.at
        else:
            f, g = self._evaluate(closure, x)
        if self.prev is not None:
            s, y = x - self.prev[0], g - self.prev[1]
            ys = y.dot(s)
            if ys > 0:
                if len(self.s) == self.memory_size:
                    del self.s[0], self.y[0], self.rho[0]
                self.s.append(s)
                self.y.append(y)
                self.rho.append(1.0 / ys)
                self.gamma = ys / y.dot(y)
        d = self._direction(g)
        gtd = float(g.dot(d))
        if not gtd < 0.0:
            # the memory gives no descent direction: forget it
            self.s, self.y, self.rho = [], [], []
            d = self._direction(g)
            gtd = float(g.dot(d))
        self.prev = (x, g)
        if not (gtd < 0.0 and math.isfinite(f)):
            return f        # a zero gradient: nothing to do
        f_new, g_new, t, _ = _strong_wolfe(
            lambda x0, t0, d0: self._evaluate(closure, x0 + t0 * d0),
            x, 1.0, d, f, g, gtd, tolerance_change=TOLERANCE_CHANGE,
            max_ls=self.max_ls)
        x_new = x + t * d
        self._set(x_new)
        self.at = (x_new, float(f_new), g_new)
        return f
