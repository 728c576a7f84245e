"""S_approx / S_approx_da vs exact tables (sapprox.c:28-114)."""
from fractions import Fraction

import numpy as np
import jax.numpy as jnp

from libstb_jax.core import sapprox
from tests.test_stirling import exact_logS


def test_s_approx_exact_cases():
    # m==1 exact for any a; identities
    got = float(sapprox.s_approx(jnp.asarray(20.0), 1, jnp.asarray(0.4)))
    from scipy.special import gammaln
    want = gammaln(20 - 0.4) - gammaln(1 - 0.4)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert float(sapprox.s_approx(jnp.asarray(5.0), 5, jnp.asarray(0.3))) == 0.0
    assert np.isneginf(float(sapprox.s_approx(jnp.asarray(3.0), 4, jnp.asarray(0.3))))
    assert np.isneginf(float(sapprox.s_approx(jnp.asarray(9.0), 5, jnp.asarray(0.3))))


def test_s_approx_small_a():
    # approximation is exact at a=0 and good for small a (sapprox.c:24-27)
    ex = exact_logS(Fraction(1, 100), 30)
    for m in (2, 3, 4):
        got = float(sapprox.s_approx(jnp.asarray(30.0), m, jnp.asarray(0.01)))
        assert abs(got - ex[(30, m)]) < 2e-3, (m, got, ex[(30, m)])


def test_s_approx_moderate_a():
    # a=1/5 keeps 1-4a > 0 (a=1/4 would hit the lgamma(0) pole for m=4,
    # exactly as the reference formula does, sapprox.c:66)
    ex = exact_logS(Fraction(1, 5), 40)
    for m in (2, 3, 4):
        got = float(sapprox.s_approx(jnp.asarray(40.0), m, jnp.asarray(0.2)))
        rel = abs(got - ex[(40, m)]) / abs(ex[(40, m)])
        assert rel < 0.02, (m, got, ex[(40, m)])


def test_s_approx_da_finite_diff():
    eps = 1e-6
    for m in (1, 2, 3, 4):
        f = lambda a: float(sapprox.s_approx(jnp.asarray(25.0), m, jnp.asarray(a, jnp.float64)))
        fd = (f(0.2 + eps) - f(0.2 - eps)) / (2 * eps)
        got = float(sapprox.s_approx_da(jnp.asarray(25.0), m, jnp.asarray(0.2)))
        np.testing.assert_allclose(got, fd, rtol=1e-3)
