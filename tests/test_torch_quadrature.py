"""The port's quadrature rules (ops/quadrature.py) against the JAX
package's: Simpson weights in both even-sample schemes and the
nucleus-adapted axes are equal bit for bit (both are built in numpy), and
the torch contractions equal the JAX ones to rtol 1e-14."""

import numpy as np
import pytest
import torch

from pinn_for_quantum_wavefunction_surfaces_tpu.ops import \
    quadrature as jquad
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import \
    quadrature as tquad

from test_torch_separable import no_jax_cache_writes  # noqa: F401


@pytest.mark.parametrize("n", [2, 3, 5, 24, 80, 81])
@pytest.mark.parametrize("scheme", ["avg", "cartwright"])
def test_simpson_weights_equal_jax(n, scheme):
    dx = 36.0 / (n - 1)
    np.testing.assert_array_equal(tquad.simpson_weights(n, dx, scheme),
                                  jquad.simpson_weights(n, dx, scheme))


def test_simpson_weights_refuse_what_jax_refuses():
    for mod in (tquad, jquad):
        with pytest.raises(ValueError):
            mod.simpson_weights(1, 0.1)
        with pytest.raises(ValueError):
            mod.simpson_weights(6, 0.1, "simpson38")


@pytest.mark.parametrize("n,centers", [(24, (-1.3, 1.3)), (48, (0.0,)),
                                       (161, (-0.2, 0.2))])
def test_adapted_axis_equals_jax(n, centers):
    for got, want in zip(tquad.adapted_axis(n, 18.0, centers),
                         jquad.adapted_axis(n, 18.0, centers)):
        np.testing.assert_array_equal(got, want)


def test_contractions_match_jax():
    rng = np.random.default_rng(5)
    f = rng.normal(size=(7, 9, 11))
    ws = [tquad.simpson_weights(m, 0.3) for m in (7, 9, 11)]
    np.testing.assert_allclose(
        float(tquad.integrate_3d(torch.as_tensor(f), *ws)),
        float(jquad.integrate_3d(f, *ws)), rtol=1e-14)
    np.testing.assert_allclose(
        float(tquad.integrate_1d(torch.as_tensor(f[0, 0]), ws[2])),
        float(jquad.integrate_1d(f[0, 0], ws[2])), rtol=1e-14)
