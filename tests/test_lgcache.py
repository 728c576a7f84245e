"""gammadiff/psidiff/qcache array-cache equivalents (lgamma.c)."""
import numpy as np
import jax.numpy as jnp
from scipy.special import gammaln, digamma as sdigamma

from libstb_jax.core import lgcache


def test_gammadiff():
    for n in (0, 1, 2, 3, 4, 57, 500):
        for alpha in (0.1, 0.7, 3.3):
            got = float(lgcache.gammadiff(n, jnp.asarray(alpha)))
            want = gammaln(n + alpha) - gammaln(alpha)
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_psidiff():
    for n in (0, 1, 2, 3, 9, 120):
        for alpha in (0.1, 0.7, 3.3):
            got = float(lgcache.psidiff(n, jnp.asarray(alpha)))
            want = sdigamma(n + alpha) - sdigamma(alpha)
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_qval_is_S_ratio():
    # qval = S^{n+1}_{2,a} / S^{n+1}_{1,a} (lgamma.c code; the /S^n_1 in
    # the reference comment is wrong -- see lgcache.qval docstring)
    from fractions import Fraction
    from tests.test_stirling import exact_logS
    import math
    ex = exact_logS(Fraction(1, 4), 12)
    for n in (3, 7, 11):
        want = math.exp(ex[(n + 1, 2)] - ex[(n + 1, 1)])
        got = float(lgcache.qval(jnp.asarray(0.25, jnp.float64), n))
        np.testing.assert_allclose(got, want, rtol=1e-9)
    # small-a branch consistency with digamma form
    got = float(lgcache.qval(jnp.asarray(0.01, jnp.float64), 9))
    ex2 = exact_logS(Fraction(1, 100), 10)
    want = math.exp(ex2[(10, 2)] - ex2[(10, 1)])
    np.testing.assert_allclose(got, want, rtol=2e-2)


def test_caches_match_pointwise():
    gt = np.asarray(lgcache.gcache_table(jnp.asarray(0.3), 20))
    for j in range(1, 20):
        np.testing.assert_allclose(gt[j], gammaln(j + 0.3) - gammaln(0.3),
                                   rtol=1e-10)
    qt = np.asarray(lgcache.qcache_table(jnp.asarray(0.25, jnp.float64), 8))
    np.testing.assert_allclose(qt[1], 1 / (1 - 0.25), rtol=1e-12)
    np.testing.assert_allclose(qt[2], 3 / (2 - 0.25), rtol=1e-12)
    np.testing.assert_allclose(qt[3], (11 - 7 * 0.25) / (3 - 0.25) / (2 - 0.25),
                               rtol=1e-12)
