"""L0 special functions vs scipy oracles (reference: lib/digamma.c,
lib/polygamma.c, lib/digammainv.c, lib/stable.c:95-103)."""
import numpy as np
import pytest
import scipy.special as sp

from libstb_jax.core import special


XS = np.concatenate([
    np.array([0.01, 0.02, 0.1, 0.3, 0.5, 0.98, 1.0, 1.5, 2.0, 3.7, 5.0]),
    np.array([5.9, 6.0, 6.1, 10.0, 57.3, 400.0, 1e4, 1e6]),
])


def test_digamma_f64():
    got = np.asarray(special.digamma(XS))
    want = sp.digamma(XS)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_digamma_f32():
    # XLA's f32 log is only ~1e-4-accurate (XLA's CPU and GPU backends alike),
    # which bounds f32 digamma accuracy; the pure-arithmetic part of the
    # computation is exact to f32 roundoff (verified in f64 above).
    got = np.asarray(special.digamma(XS.astype(np.float32)))
    want = sp.digamma(XS)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=2e-4)


def test_trigamma():
    got = np.asarray(special.trigamma(XS))
    want = sp.polygamma(1, XS)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_tetragamma():
    got = np.asarray(special.tetragamma(XS))
    want = sp.polygamma(2, XS)
    np.testing.assert_allclose(got, want, rtol=1e-11)


def test_pentagamma():
    got = np.asarray(special.pentagamma(XS))
    want = sp.polygamma(3, XS)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_digamma_inv_roundtrip():
    # digammainv.c:27-38 contract: inverse on the range digamma covers.
    xs = np.array([0.05, 0.3, 1.0, 2.5, 10.0, 70.0])
    y = sp.digamma(xs)
    got = np.asarray(special.digamma_inv(y))
    np.testing.assert_allclose(got, xs, rtol=1e-8)


def test_logadd():
    a, b = 3.0, -2.0
    np.testing.assert_allclose(
        float(special.logadd(a, b)), np.logaddexp(a, b), rtol=1e-14)
    assert np.isneginf(float(special.logadd(-np.inf, -np.inf)))


def test_logdiff():
    # samplea.c:233-239 logminus semantics.  NOTE: XLA:CPU's f64 exp/expm1
    # are only ~1.5e-8-accurate (backend approximation), which bounds the
    # achievable tolerance here.
    x, y = 2.0, 1.0
    want = np.log(np.exp(x) - np.exp(y))
    np.testing.assert_allclose(float(special.logdiff(x, y)), want, rtol=1e-7)
    assert np.isneginf(float(special.logdiff(1.0, 1.0)))
    assert np.isneginf(float(special.logdiff(1.0, 2.0)))
    # tiny differences stay finite and accurate
    x, y = 5.0, 5.0 - 1e-9
    want = np.log(-np.expm1(y - x)) + x
    np.testing.assert_allclose(float(special.logdiff(x, y)), want, rtol=1e-7)


def test_log1mexp():
    ds = np.array([-1e-8, -0.1, -0.693, -0.694, -5.0, -50.0])
    want = np.log1p(-np.exp(ds))
    got = np.asarray(special.log1mexp(ds))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-12)


def test_vmap_and_jit():
    import jax
    f = jax.jit(jax.vmap(special.digamma))
    got = np.asarray(f(XS))
    np.testing.assert_allclose(got, sp.digamma(XS), rtol=1e-12)
