"""NGG generalized-Stirling subsystem vs scipy / quadrature oracles
(the test/ngg_test.c + test/ngg_integral.cpp validation methodology)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import gammaincc, gamma as _gamma

from libstb_jax.core import ngg, quadrature

A, M = 0.1, 10.0       # the reference's p_a, p_M (ngg_test.c:506)


def test_gamma_inc_cf_vs_scipy():
    for s, x in [(2.5, 3.0), (0.5, 10.0), (5.0, 1.0), (1.0, 0.5)]:
        got = float(ngg.log_gamma_inc_upper(s, x))
        want = np.log(gammaincc(s, x) * _gamma(s))
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_gamma_inc_negative_s_recurrence():
    # Gamma(s, x) = (Gamma(s+1, x) - x^s e^-x) / s  checks negative-s CF
    x = 10.0
    for s in [-0.5, -3.7, -20.0]:
        g1 = np.exp(float(ngg.log_gamma_inc_upper(s + 1.0, x)))
        gs = np.exp(float(ngg.log_gamma_inc_upper(s, x)))
        np.testing.assert_allclose(gs, (g1 - x ** s * np.exp(-x)) / s,
                                   rtol=1e-9, err_msg=f"s={s}")


def test_table_vs_quadrature():
    # (16,10) is excluded: at a=0.1 the alternating binomial sum loses
    # ~12 digits there and f64 (vs the reference's 64-bit-mantissa long
    # double) no longer tracks the quadrature oracle; the ratio table
    # (quadrature-seeded) is the supported large-(n,k) path.
    N, K = 16, 10
    tab = np.asarray(ngg.ngg_table(A, M, N, K))
    for (n, k) in [(10, 3), (14, 5), (15, 1), (12, 8)]:
        q = float(ngg.ngg_quadrature_log(A, M, n, k))
        np.testing.assert_allclose(tab[k - 1, n - 1], q, rtol=0, atol=2e-4,
                                   err_msg=f"n={n} k={k}")


def test_saddle_point_accuracy():
    # umax approximates the table within the Gaussian-approx error the
    # reference main() displays side by side (ngg_test.c:517-527)
    N, K = 16, 10
    tab = np.asarray(ngg.ngg_table(A, M, N, K))
    for (n, k) in [(10, 3), (14, 5), (12, 8)]:
        u = float(ngg.umax_log(A, M, n, k))
        assert abs(u - tab[k - 1, n - 1]) < 0.1, (n, k)


def test_ratio_table_matches_diffs():
    N, K = 14, 7
    tab = np.asarray(ngg.ngg_table(A, M, N, K))
    R = np.asarray(ngg.ngg_ratio_table(A, M, N, K))
    for k in range(1, K + 1):
        for n in range(k, N):
            want = np.exp(tab[k - 1, n] - tab[k - 1, n - 1])
            np.testing.assert_allclose(R[k - 1, n - 1], want, rtol=1e-7,
                                       err_msg=f"k={k} n={n}")


def test_t_l1_t_l2_helpers():
    # T_L1/T_L2 (ngg_test.c:484-499) from the ratio table, checked against
    # the ground-truth log-table differences: T_L2 = T[k][n-1]/T[k][n]
    # + (k - n/a) = 1/R[k][n-1] + (k - n/a).
    N, K = 14, 7
    tab = np.asarray(ngg.ngg_table(A, M, N, K))
    R = ngg.ngg_ratio_table(A, M, N, K)
    for k in range(1, K + 1):
        for n in range(max(k + 1, 2), N):
            l1 = float(ngg.t_l1(R, n, k))
            np.testing.assert_allclose(
                l1, np.exp(tab[k - 1, n] - tab[k - 1, n - 1]), rtol=1e-7)
            l2 = float(ngg.t_l2(R, n, k, A))
            want = np.exp(tab[k - 1, n - 2] - tab[k - 1, n - 1]) + (k - n / A)
            np.testing.assert_allclose(l2, want, rtol=2e-6, atol=1e-8,
                                       err_msg=f"k={k} n={n}")


def test_ratio_table_large_n_stable():
    # auto switches to the quadrature method at large n, which stays
    # finite and positive far beyond where the alternating sum dies
    R = np.asarray(ngg.ngg_ratio_table(0.3, 5.0, 200, 12))
    valid = R[:, 50:]
    assert np.isfinite(valid).all()
    assert (valid[11][60:] > 0).all()
    # and agrees with the recurrence in the small-n overlap
    Rs = np.asarray(ngg.ngg_ratio_table(0.3, 5.0, 20, 6,
                                        method="recurrence"))
    Rq = np.asarray(ngg.ngg_ratio_table(0.3, 5.0, 20, 6,
                                        method="quadrature"))
    # tolerance reflects the recurrence's ~(n/a)-per-step amplification
    # of its alternating-sum base error, not quadrature error
    for k in range(1, 7):
        for n in range(k, 15):
            np.testing.assert_allclose(Rq[k - 1, n - 1], Rs[k - 1, n - 1],
                                       rtol=1e-4, err_msg=f"k={k} n={n}")


def test_tanh_sinh_known_integrals():
    # smooth: int_0^1 x^2 = 1/3; peaked: int_-1^1 exp(-50 x^2)
    v = float(quadrature.tanh_sinh(lambda x: x * x, 0.0, 1.0))
    np.testing.assert_allclose(v, 1.0 / 3.0, rtol=1e-10)
    v2 = float(quadrature.tanh_sinh(
        lambda x: jnp.exp(-50.0 * x * x), -1.0, 1.0, levels=11))
    np.testing.assert_allclose(v2, np.sqrt(np.pi / 50.0), rtol=1e-8)
    # log form on a sharp exponential
    lv = float(quadrature.tanh_sinh_log(lambda x: -100.0 * x, 0.0, 5.0))
    np.testing.assert_allclose(lv, np.log(1.0 / 100.0), rtol=1e-6)


def test_quadrature_batched():
    n = jnp.asarray([5.0, 8.0, 12.0])
    k = jnp.asarray([2.0, 3.0, 4.0])
    out = ngg.ngg_quadrature_log(jnp.full((3,), A), jnp.full((3,), M), n, k)
    for i in range(3):
        single = float(ngg.ngg_quadrature_log(A, M, float(n[i]), float(k[i])))
        np.testing.assert_allclose(float(out[i]), single, rtol=1e-10)


def test_four_way_cross_check():
    """The reference cross-validates FOUR independent approximations of
    log(Gamma(N)/a^{N-1} T^{N,K}): the exact table, quadrature, and the
    u- and x-representation saddle points (ngg_integral.cpp:431-495).
    All must agree: table == windowed quadrature tightly; saddle points
    within their Gaussian-approximation error; gmax (the independent
    second representation, ngg_integral.cpp:173-243) tracks the truth to
    <1% of magnitude."""
    a, M = 0.1, 10.0
    tab = np.asarray(ngg.ngg_table(a, M, 16, 10))
    for (n, k) in ((3, 2), (6, 5), (10, 5), (15, 5)):
        t = tab[k - 1, n - 1]
        q = float(ngg.ngg_quadrature_log(a, M, n, k))
        u = float(ngg.umax_log(a, M, n, k))
        h = float(ngg.hmax_log(a, M, n, k))
        h2 = float(ngg.hmax2_log(a, M, n, k, iters=200))
        g = float(ngg.gmax_log(a, M, n, k))
        assert abs(q - t) < 1e-5, (n, k, q, t)          # exact methods
        assert abs(g - t) < 0.05, (n, k, g, t)          # 2nd-rep saddle
        assert abs(u - t) < 0.1, (n, k, u, t)           # u-rep saddle
        assert abs(h - t) < 0.8, (n, k, h, t)           # x-rep saddle
        # hmax2 is the fixed-point variant of hmax: same maximizer
        assert abs(h2 - h) < 1e-4, (n, k, h2, h)
    # large (N, K): the saddle family must agree with ITSELF (the table
    # route cancels catastrophically there -- module docstring) and with
    # the hmax-windowed quadrature below
    for (n, k) in ((1000, 50), (10000, 200)):
        u = float(ngg.umax_log(a, M, n, k))
        g = float(ngg.gmax_log(a, M, n, k))
        h = float(ngg.hmax_log(a, M, n, k))
        assert abs(u - g) < 1e-2 * abs(u), (n, k, u, g)
        assert abs(u - h) < 1e-2 * abs(u) + 1.5, (n, k, u, h)


def test_hmax_bounds_window_quadrature():
    """hmax's integration window (hval_min/hval_max,
    ngg_integral.cpp:122-123,450) must bracket the mass: tanh-sinh on
    [lo, hi] reproduces the table at small N AND stays accurate at
    (N, K) where the naive full-range quadrature loses the peak."""
    import jax.numpy as jnp
    from libstb_jax.core import quadrature
    a, M = 0.1, 10.0
    tab = np.asarray(ngg.ngg_table(a, M, 16, 10))

    def windowed(n, k):
        la, x, lo, hi = ngg.hmax_log(a, M, n, k, with_bounds=True)
        af = jnp.float64(a); Mf = jnp.float64(M)
        Nf = jnp.float64(n); Kf = jnp.float64(k)
        q = quadrature.tanh_sinh_log(
            lambda s: -ngg._h(s, af, Mf, Nf, Kf),
            jnp.maximum(lo, 1e-14)[None], hi[None], 11)[0]
        return float(q + k * np.log(M) + np.log(a))

    for (n, k) in ((3, 2), (10, 5), (15, 5)):
        assert abs(windowed(n, k) - tab[k - 1, n - 1]) < 1e-5
    # regime where the unwindowed integral underresolves the peak
    n, k = 10000, 200
    full = float(ngg.ngg_quadrature_log(a, M, n, k))
    win = windowed(n, k)
    u = float(ngg.umax_log(a, M, n, k))
    assert abs(win - u) < 1e-2 * abs(u)
    assert abs(win - full) > 1.0          # the window genuinely rescues it


def test_hmax2_signals_divergence():
    """Outside its contraction domain (a (1 + (Ka+1)/D*) >= 1) hmax2
    must return NaN, not a silently wrong area."""
    v = np.asarray(ngg.hmax2_log(0.1, 10.0, 1000.0, 50.0))
    assert np.isnan(v)
