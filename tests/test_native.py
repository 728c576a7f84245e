"""Native C++ oracle (long-double fill + CRP generator) vs the JAX paths."""
import jax.numpy as jnp
import numpy as np
import pytest

from libstb_jax import native
from libstb_jax.core import stirling

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no native toolchain")


def test_fill_ref_matches_f64_scan():
    logS, V, S1 = native.fill_ref(0.5, 300, 60)
    v64, s64, _ = stirling.fill_rows(0.5, 300, 60, dtype=jnp.float64)
    s1 = stirling.s1_host(0.5, 300)
    full = np.asarray(s64) + s1[:, None]
    fin = np.isfinite(logS)
    assert np.max(np.abs(logS[fin] - full[fin])) < 1e-10
    finv = fin & np.isfinite(np.asarray(v64))
    np.testing.assert_allclose(V[finv], np.asarray(v64)[finv], rtol=1e-12)
    np.testing.assert_allclose(S1, s1, rtol=1e-13)


def test_fill_ref_exact_small_n():
    # against exact rationals at a=1/2 (the golden-value strategy)
    from fractions import Fraction
    a = Fraction(1, 2)
    N, M = 20, 8
    S = {(1, 1): Fraction(1)}
    for n in range(2, N + 1):
        for m in range(1, min(n, M) + 1):
            S[(n, m)] = (S.get((n - 1, m - 1), Fraction(0))
                         + (n - 1 - m * a) * S.get((n - 1, m), Fraction(0)))
    logS, _, _ = native.fill_ref(0.5, N, M)
    for n in range(1, N + 1):
        for m in range(1, min(n, M) + 1):
            want = float(np.log(float(S[(n, m)])))
            np.testing.assert_allclose(logS[n - 1, m - 1], want, atol=1e-12,
                                       err_msg=f"({n},{m})")


def test_crp_generate_statistics():
    # E[T] for PYP(a, b) after n draws = (b/a) ((b+a)_n / (b)_n - 1),
    # (x)_n the rising factorial; check the generator's latent T mean.
    from scipy.special import gammaln
    a, b, n = 0.5, 5.0, 200
    reps = 400
    Ts = []
    for s in range(reps):
        _, _, T = native.crp_generate(s + 1, 1, 50, n, a, b,
                                      return_latent=True)
        Ts.append(int(T[0]))
    Ts = np.asarray(Ts, np.float64)
    want = (b / a) * (np.exp(gammaln(b + a + n) - gammaln(b + a)
                             - gammaln(b + n) + gammaln(b)) - 1.0)
    se = Ts.std(ddof=1) / np.sqrt(reps)
    assert abs(Ts.mean() - want) < 5 * se, (Ts.mean(), want, se)
    # internal consistency: counts match item streams
    d = native.crp_generate(3, 2, 12, 80, a, b)
    for j in range(2):
        sel = d.data_grp == j
        counts = np.bincount(d.data_cat[sel], minlength=12)
        np.testing.assert_array_equal(counts, d.n[j])
    assert d.first.sum() == (d.n > 0).sum()


def test_crp_generate_respects_base():
    H = np.zeros(10)
    H[3] = 0.5
    H[7] = 0.5
    d = native.crp_generate(11, 1, 10, 100, 0.3, 2.0, H=H)
    used = set(np.nonzero(d.n[0])[0].tolist())
    assert used <= {3, 7}
