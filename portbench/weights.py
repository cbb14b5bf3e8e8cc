"""The run's initial weights, made on the device from ``--seed``.

The families' init scheme, as the package describes it: every linear layer
U(+/- 1/sqrt(fan_in)) for weight and bias, E(R)'s output bias -1, the
alpha(R) and b(R) heads' output layers zero with the biases that give
alpha = 1 and b = 0.1, and the separable family's log-correction output
layers zero (its init is exactly the GZ ansatz). One uniform draw of every
value from a ``torch.Generator`` on the device, in float64, cut into the
leaves and cast once to the run's type: the benchmark makes the weights
and hands the same to the program and to the reference.

In a run the values come from one draw of a fixed seed (``BASE_SEED``),
and ``--seed`` permutes the hidden units of every layer (a layer's output
columns and bias, and the next layer's input rows): every seed's network
computes the same function in another order of its units, so the seed
does not vary the weights' values. Drawn values themselves change the
work a step does (float64 tanh and exp branch on their arguments): on the
flagship polish, twelve runs of six seeds drawn apart read two rates 4.5%
apart, each seed the same rate in both sets. ``calibrate.py --drawn``
draws every seed's values apart (``base`` = the seed), so that the limits
of ``correct`` are read over networks that differ.
"""

from __future__ import annotations

import math

import torch

ALPHA_BIAS = math.atanh((1.0 - 1.5) / 0.75)     # alpha(R) = 1 at init
BETA_BIAS = math.atanh(0.1 / 0.75 - 1.0)        # b(R) = 0.1 at init
EOUT_BIAS = -1.0
BASE_SEED = 12345
# the layers whose hidden units feed the next: a unit's permutation moves
# its column of the first and its row of the second
CHAINS = (("e1", "e2", "eout"), ("alpha1", "alpha2"), ("beta1", "beta2"),
          ("lam1", "lam2", "lamout"), ("mu1", "mu2", "muout"),
          ("h1", "h2", "out"), ("gate1", "gate2"))


def layout(model: dict) -> list[tuple[str, int, int, str]]:
    """(name, d_in, d_out, init) of every layer of the model: "uniform",
    or "zero:<bias>" for a zero weight and a constant bias, or
    "uniform:<bias>" for a uniform weight and a constant bias."""
    h, he, ha = model["hidden"], model["hidden_e"], model["hidden_alpha"]
    layers = [("e1", 1, he, "uniform"), ("e2", he, he, "uniform"),
              ("eout", he, 1, f"uniform:{EOUT_BIAS}"),
              ("alpha1", 1, ha, "uniform"),
              ("alpha2", ha, 1, f"zero:{ALPHA_BIAS}"),
              ("beta1", 1, ha, "uniform"),
              ("beta2", ha, 1, f"zero:{BETA_BIAS}")]
    if model["arch"] == "separable":
        for mlp in ("lam", "mu"):
            layers += [(mlp + "1", 2, h, "uniform"),
                       (mlp + "2", h, h, "uniform"),
                       (mlp + "out", h, 1, "zero:0.0")]
    else:
        hg = model["hidden_gate"]
        layers += [("h1", 2, h, "uniform"), ("h2", h, h, "uniform"),
                   ("out", h, 1, "uniform"), ("gate1", 1, hg, "uniform"),
                   ("gate2", hg, 1, "uniform")]
    return layers


def make(model: dict, seed: int, dtype, device, base=None) -> dict:
    """{name: {"w": (d_in, d_out), "b": (d_out,)}} in ``dtype`` on
    ``device``: one draw of ``base`` (``BASE_SEED`` where None), the hidden
    units permuted by a generator seeded with ``seed``."""
    lay = layout(model)
    total = sum(i * o + o for _, i, o, _ in lay)
    base = torch.Generator(device=device).manual_seed(
        BASE_SEED if base is None else int(base))
    u = torch.rand(total, generator=base, dtype=torch.float64, device=device)
    u = 2.0 * u - 1.0
    params, at = {}, 0
    for name, d_in, d_out, init in lay:
        bound = 1.0 / math.sqrt(d_in)
        w = u[at:at + d_in * d_out].view(d_in, d_out) * bound
        b = u[at + d_in * d_out:at + d_in * d_out + d_out] * bound
        at += d_in * d_out + d_out
        kind, _, bias = init.partition(":")
        if kind == "zero":
            w = torch.zeros_like(w)
        if bias:
            b = torch.full_like(b, float(bias))
        params[name] = {"w": w, "b": b}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for chain in CHAINS:
        for a, b in zip(chain, chain[1:]):
            if a in params:
                perm = torch.randperm(params[a]["b"].numel(), generator=gen,
                                      device=device)
                params[a]["w"] = params[a]["w"][:, perm]
                params[a]["b"] = params[a]["b"][perm]
                params[b]["w"] = params[b]["w"][perm, :]
    return {k: {f: t.to(dtype).contiguous() for f, t in v.items()}
            for k, v in params.items()}
