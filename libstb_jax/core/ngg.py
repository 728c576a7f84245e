"""Generalized Stirling-like numbers for the Normalized Generalized Gamma
(NGG) process.

Reproduces the capabilities of test/ngg_test.c:

* ``log_gamma_inc_upper`` -- log Gamma(s, x) for arbitrary real s (incl.
  the very negative s = K - n/a the NGG sums need) via the Lentz-form
  continued fraction (ngg_test.c:38-76, after Plesser) with a fixed
  vectorised iteration count.
* ``ngg_base_row`` -- the K=1 row  S[1][n] = log( Gamma(n)/a^{n-1}
  T^{n,1}_{a,M} ) by the alternating binomial sum over incomplete gammas
  (ngg_test.c:128-247, "standard summation of Eqn (26)"); compensated
  f64 summation replaces the reference's long double.
* ``ngg_table`` -- the cross-K log-difference recursion
  S[k][n] = logdiff( log((n-1)/a) + S[k-1][n-1],
                     log((n-1)/a - (k-1)) + S[k-1][n] )
  (ngg_test.c:249-292) as a lax.scan over k with vectorised n-rows.
* ``ngg_ratio_table`` -- the float-stable ratio table Lambda1 T (T_make /
  T_remake / T_L1 / T_L2, ngg_test.c:442-499).
* ``umax_log`` / ``smax_log`` -- Gaussian saddle-point approximations of
  the integral representations (ngg_test.c:296-416), vectorised Newton
  with the same step clamping; both return approximations of S[k][n]
  directly (the reference's main() adds K log M - M when comparing,
  ngg_test.c:523-526).

The table route (alternating sum) cancels catastrophically beyond n ~ 35
even in f64 -- exactly why the reference caps MAXN at 16 -- so the
scalable large-n path is the saddle point, validated against tanh-sinh
quadrature (core/quadrature.py) the way test/ngg_integral.cpp does.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import special

__all__ = ["log_gamma_inc_upper", "ngg_base_row", "ngg_table",
           "ngg_ratio_table", "t_l1", "t_l2", "umax_log", "smax_log",
           "hmax_log", "hmax2_log", "gmax_log", "ngg_quadrature_log"]


def log_gamma_inc_upper(s, x, iters: int = 400):
    """log Gamma(s, x) (upper), valid for any real s and x > 0.

    Lentz-evaluated continued fraction: Gamma(s, x) = x^{s-1} e^{-x} F,
      F = 1/(1+ a_2/(1+ a_3/(1+ ...))),  a_{2j} = (j - s)/x wait --
    following ngg_test.c:54-60: odd n: a_n = ((n-1)/2)/x, even n:
    a_n = (n/2 - s)/x.  Convergence needs x not too small relative to
    |s|; the NGG workloads use x = M >= 1.
    """
    s = jnp.asarray(s, jnp.result_type(float))
    x = jnp.asarray(x, s.dtype)
    small = jnp.asarray(1e-30, s.dtype)

    def body(n, carry):
        hn, Cn, Dn = carry
        odd = n % 2 == 1
        an = jnp.where(odd, 0.5 * (n - 1) / x, (0.5 * n - s) / x)
        Dn = 1.0 + an * Dn
        Dn = jnp.where(jnp.abs(Dn) < small, small, Dn)
        Cn = 1.0 + an / Cn
        Cn = jnp.where(jnp.abs(Cn) < small, small, Cn)
        Dn = 1.0 / Dn
        return hn * Cn * Dn, Cn, Dn

    hn = jnp.ones_like(s * x)
    Cn = jnp.full_like(hn, 1e30)
    Dn = jnp.ones_like(hn)
    hn, _, _ = jax.lax.fori_loop(2, iters, body, (hn, Cn, Dn))
    return jnp.log(hn) + (s - 1.0) * jnp.log(x) - x


def ngg_base_row(a: float, M: float, n_max: int):
    """S[1][n] for n = 1..n_max (f64 host/XLA; see module docstring).

    S[1][n] = log( sum_{i=0}^{n-1} (-1)^i C(n-1, i) G_i ) - M,
    G_i = Gamma(1 - i/a, M) M^{i/a} e^M   (ngg_test.c:136-146, 232-239).
    """
    i = jnp.arange(n_max, dtype=jnp.float64)
    logG = log_gamma_inc_upper(1.0 - i / a, jnp.float64(M)) \
        + jnp.log(jnp.float64(M)) * i / a + M
    G = jnp.exp(logG - logG[0])          # scale by G_0 for headroom

    def row(n):
        # C(n-1, i) for i <= n-1
        nf = jnp.float64(n)
        logc = (jax.lax.lgamma(nf) - jax.lax.lgamma(i + 1.0)
                - jax.lax.lgamma(jnp.maximum(nf - i, 1.0)))
        sign = 1.0 - 2.0 * (i % 2)
        term = jnp.where(i <= nf - 1.0, sign * jnp.exp(logc) * G, 0.0)
        # compensated sum small-to-large in |term| is overkill here;
        # pairwise via jnp.sum (f64) matches the reference's long-double
        # headroom for n <= ~35
        return jnp.sum(term)

    sums = jax.vmap(row)(jnp.arange(1, n_max + 1))
    return jnp.log(sums) + logG[0] - M


@functools.partial(jax.jit, static_argnames=("n_max", "k_max"))
def ngg_table(a: float, M: float, n_max: int, k_max: int):
    """Full table S[k][n], k = 1..k_max as rows (k_max, n_max).

    Row 1 from ``ngg_base_row``; rows 2.. by the log-difference recursion
    (ngg_test.c:276-291).  Cells with k > n are -inf.
    """
    base = ngg_base_row(a, M, n_max)
    n = jnp.arange(1, n_max + 1, dtype=base.dtype)

    def step(prev, k):
        kf = k.astype(base.dtype)
        # S[k][n] = logdiff(log((n-1)/a) + S[k-1][n-1],
        #                   log((n-1)/a - (k-1)) + S[k-1][n])
        shifted = jnp.concatenate([jnp.full((1,), -jnp.inf, base.dtype),
                                   prev[:-1]])
        lhs = jnp.log(jnp.maximum((n - 1.0) / a, 1e-300)) + shifted
        rhs = jnp.log(jnp.maximum((n - 1.0) / a - (kf - 1.0), 1e-300)) + prev
        new = special.logdiff(lhs, rhs)
        new = jnp.where(n >= kf, new, -jnp.inf)
        return new, new

    ks = jnp.arange(2, k_max + 1)
    _, rows = jax.lax.scan(step, base, ks)
    return jnp.concatenate([base[None], rows], axis=0)


@functools.partial(jax.jit, static_argnames=("n_max", "k_max", "method"))
def ngg_ratio_table(a: float, M: float, n_max: int, k_max: int,
                    table=None, method: str = "auto"):
    """Lambda1-ratio table R[k][n] = exp(S[k][n+1] - S[k][n]) by a
    rational recurrence in k (the T_remake capability, ngg_test.c:455-470).

    Derived by dividing the T recursion
      T[k+1][n] = (n-1)/a T[k][n-1] - ((n-1)/a - k) T[k][n]
    through by T[k][n]:

      R[k+1][n] = ( n/a - (n/a - k) R[k][n] )
                  / ( k + (n-1)/a (1/R[k][n-1] - 1) ).

    (The numerator printed in the reference's REPORT1 trace has k instead
    of k R[k][n] -- the reference prints both columns side by side rather
    than asserting, and the exp(S-diff) column is the ground truth; tests
    here assert agreement with it.)  Float-stable at large n (the V-table
    analog).  Returns (k_max, n_max-1) with R[k][n] at [k-1, n-1], valid
    for n >= k; T_L2 derives as 1/R[k][n-1] + (k - n/a).

    Two methods:
    * "recurrence" -- the k-recursion above, seeded from the K=1 row.
      Exact at small n, but the update amplifies base error by ~n/a per
      k-step, so it degrades for n/a >> k (like the reference's, whose
      MAXN is 16).
    * "quadrature" -- R[k][n] = exp(Q(n+1,k) - Q(n,k)) with Q the
      tanh-sinh integral (ngg_quadrature_log): stable at any (n, k) and
      embarrassingly parallel over the whole table -- the large-n
      path.
    "auto" picks recurrence for n_max <= 32 else quadrature.
    """
    if method == "auto":
        method = "recurrence" if n_max <= 32 else "quadrature"
    dt = jnp.result_type(float)
    if method == "quadrature":
        n = jnp.arange(1, n_max + 1, dtype=dt)
        k = jnp.arange(1, k_max + 1, dtype=dt)
        nn, kk = jnp.meshgrid(n, k, indexing="xy")    # (K, N)
        q = ngg_quadrature_log(jnp.full_like(nn, a), jnp.full_like(nn, M),
                               nn, kk)
        r = jnp.exp(q[:, 1:] - q[:, :-1])
        valid = nn[:, :-1] >= kk[:, :-1]
        return jnp.where(valid, r, 0.0)
    if table is None:
        table = ngg_table(a, M, n_max, 1)
    base = jnp.exp(table[0][1:] - table[0][:-1])     # R[1][n], n=1..n_max-1
    n = jnp.arange(1, n_max, dtype=base.dtype)

    def step(prev, k):
        kf = k.astype(base.dtype)
        shifted = jnp.concatenate([jnp.ones((1,), base.dtype), prev[:-1]])
        numer = n / a - (n / a - kf) * prev
        denom = kf + (1.0 / shifted - 1.0) * (n - 1.0) / a
        new = numer / denom
        new = jnp.where(n >= kf + 1.0, new, 0.0)
        return new, new

    ks = jnp.arange(1, k_max)
    _, rows = jax.lax.scan(step, base, ks)
    return jnp.concatenate([base[None], rows], axis=0)


def t_l1(rtab, n, k):
    """Lambda1 ratio T[k][n+1]/T[k][n] from a ``ngg_ratio_table`` result
    (T_L1, ngg_test.c:484-490): R[k][n] lives at rtab[k-1, n-1]."""
    n = jnp.asarray(n)
    k = jnp.asarray(k)
    return rtab[k - 1, n - 1]


def t_l2(rtab, n, k, a):
    """Lambda2 ratio  1/R[k][n-1] + (k - n/a)  (T_L2, ngg_test.c:491-499).

    Derived from the cross-k recursion: dividing
    T[k+1][n] = (n-1)/a T[k][n-1] - ((n-1)/a - k) T[k][n] by T[k][n]
    relates the n-ratio of row k to the k-step at (n, k); the reference
    packages the reciprocal-plus-linear form as its second Lambda ratio.
    ``rtab`` is an ``ngg_ratio_table`` result (R[k][n] at [k-1, n-1]),
    so the lookup index for R[k][n-1] is [k-1, n-2]; valid for n >= 2,
    n-1 >= k (the reference asserts n >= 2 and bounds only,
    ngg_test.c:492-496)."""
    n = jnp.asarray(n)
    k = jnp.asarray(k)
    dt = rtab.dtype
    return (1.0 / rtab[k - 1, n - 2]
            + (k.astype(dt) - n.astype(dt) / jnp.asarray(a, dt)))


def umax_log(a, M, N, K, iters: int = 40):
    """Saddle-point approximation of S[K][N] via the u-representation
    (ngg_test.c:372-416), vectorised Newton with the reference's +-2u
    step clamp.  Returns log(Gamma(N)/a^{N-1} T^{N,K}) ~ table value
    (the K log M - M shift of ngg_test.c:524 is included here).
    """
    a = jnp.asarray(a, jnp.result_type(float))
    M = jnp.asarray(M, a.dtype)
    N = jnp.asarray(N, a.dtype)
    K = jnp.asarray(K, a.dtype)

    def body(_, u):
        eu = jnp.exp(u)
        delta = (N - K * a) * eu / (1 + eu) - N + a * M * eu \
            * jnp.exp((a - 1.0) * jnp.log1p(eu))
        dd = ((N - K * a) * eu / (1 + eu) ** 2
              + a * a * M * eu * jnp.exp((a - 1.0) * jnp.log1p(eu))
              + a * (1 - a) * M * eu * jnp.exp((a - 2.0) * jnp.log1p(eu)))
        step = delta / dd
        step = jnp.clip(step, -2.0 * jnp.abs(u), 2.0 * jnp.abs(u))
        return u - step

    u = jax.lax.fori_loop(0, iters, body,
                          jnp.full(jnp.broadcast_shapes(
                              a.shape, M.shape, N.shape, K.shape), 0.1,
                              a.dtype))
    eu = jnp.exp(u)
    sigma = ((N - K * a) * eu / (1 + eu) ** 2
             + a * a * M * eu * jnp.exp((a - 1.0) * jnp.log1p(eu))
             + a * (1 - a) * M * eu * jnp.exp((a - 2.0) * jnp.log1p(eu)))
    return (0.5 * jnp.log(2 * jnp.pi / sigma)
            - ((N - K * a) * jnp.log1p(eu) - N * u
               - M * (1.0 - jnp.exp(a * jnp.log1p(eu))))
            + K * jnp.log(M) - M + jnp.log(a))


def smax_log(a, M, N, K, iters: int = 40):
    """Saddle point via the s = u/(1+u) representation (ngg_test.c:296-
    370); same normalisation as ``umax_log``."""
    a = jnp.asarray(a, jnp.result_type(float))
    M = jnp.asarray(M, a.dtype)
    N = jnp.asarray(N, a.dtype)
    K = jnp.asarray(K, a.dtype)

    def body(_, s):
        omx = 1.0 - s
        delta = (N - 1) / s + (1 + K * a) / omx \
            - a * M * jnp.exp(-(1 + a) * jnp.log(omx))
        dd = (-(N - 1) / s ** 2 + (1 + K * a) / omx ** 2
              - a * (1 + a) * M * jnp.exp(-(2 + a) * jnp.log(omx)))
        step = delta / (-dd)
        step = jnp.clip(step, -0.1, 0.1)
        s_new = s + step
        s_new = jnp.where(s_new <= 0, s / 2, s_new)
        s_new = jnp.where(s_new >= 1, s + (1 - s) / 2, s_new)
        return s_new

    shape = jnp.broadcast_shapes(a.shape, M.shape, N.shape, K.shape)
    s = jax.lax.fori_loop(0, iters, body, jnp.full(shape, 0.5, a.dtype))
    omx = 1.0 - s
    sigma = -(-(N - 1) / s ** 2 + (1 + K * a) / omx ** 2
              - a * (1 + a) * M * jnp.exp(-(2 + a) * jnp.log(omx)))
    return (0.5 * jnp.log(2 * jnp.pi / sigma)
            + (N - 1) * jnp.log(s) - (1 + K * a) * jnp.log(omx)
            + M * (1.0 - jnp.exp(-a * jnp.log(omx)))
            + K * jnp.log(M) - M + jnp.log(a))


def _h(x, a, M, N, K):
    """h(x) = -(N-1) log x + (K a + 1) log(1-x) + M (1-x)^-a
    (ngg_integral.cpp:37-39): minus the log integrand of the [0,1]
    representation."""
    return (-(N - 1.0) * jnp.log(x) + (K * a + 1.0) * jnp.log1p(-x)
            + M * jnp.exp(-a * jnp.log1p(-x)))


def _ddh(x, a, M, N, K):
    omx = 1.0 - x
    return (-(K * a + 1.0) / omx / omx + (N - 1.0) / x / x
            + M * a * (1.0 + a) * jnp.exp(-(2.0 + a) * jnp.log(omx)))


def hmax_log(a, M, N, K, iters: int = 60, relerror: float = 1e-10,
             interror: float = 1e-10, with_bounds: bool = False):
    """Safeguarded-Newton maximizer of the [0,1] integral representation
    (``hmax``, ngg_integral.cpp:47-130), vectorised.

    Same representation as ``smax_log`` but with the reference hmax's
    own safeguards: a Newton step when h'' > 0, otherwise a halved
    gradient-direction step, with the 0.7-fraction boundary clamps.
    Returns the Gaussian log-area  0.5 log(2 pi / h'') - h(x*)
    + K log M + log a  (ngg_integral.cpp:121); with ``with_bounds`` also
    the (hval_min, hval_max) window where the integrand is within
    ``interror`` of its peak -- the reference uses it to bound the
    DEIntegrator pass (ngg_integral.cpp:450).
    """
    a = jnp.asarray(a, jnp.result_type(float))
    M = jnp.asarray(M, a.dtype)
    N = jnp.asarray(N, a.dtype)
    K = jnp.asarray(K, a.dtype)
    shape = jnp.broadcast_shapes(a.shape, M.shape, N.shape, K.shape)
    x0 = jnp.full(shape, 0.5, a.dtype)

    def dh(x):
        omx = 1.0 - x
        return (-(N - 1.0) / x - (K * a + 1.0) / omx
                + M * a * jnp.exp(-(1.0 + a) * jnp.log(omx)))

    def body(i, st):
        x, olddelta = st
        delta = dh(x)
        dd = _ddh(x, a, M, N, K)
        # ddh <= 0: fall back to a (signed) remembered step, halved until
        # it descends (ngg_integral.cpp:63-94); in vector form one
        # halving per iteration suffices -- the loop re-checks
        fallback = jnp.where(delta < 0, -jnp.abs(olddelta),
                             jnp.abs(olddelta))
        step = jnp.where(dd > 0, delta / jnp.where(dd > 0, dd, 1.0),
                         fallback)
        # boundary clamps (ngc hmax: eu - delta must stay in (0, 1))
        step = jnp.where(x - step <= 0, x * 0.7, step)
        step = jnp.where(x - step >= 1, -(1.0 - x) * 0.7, step)
        # descent check for the fallback branch
        worse = (dd <= 0) & (_h(x - step, a, M, N, K) >= _h(x, a, M, N, K))
        step = jnp.where(worse, step / 2.0, step)
        return x - step, step * 0.9

    x, _ = jax.lax.fori_loop(0, iters, body, (x0, jnp.full(shape, 0.1,
                                                           a.dtype)))
    sigma = _ddh(x, a, M, N, K)
    logarea = (0.5 * jnp.log(2 * jnp.pi / sigma) - _h(x, a, M, N, K)
               + K * jnp.log(M) + jnp.log(a))
    if not with_bounds:
        return logarea
    lo = jnp.where(N > 1, x * jnp.exp(jnp.log(interror) / (N - 1.0)), 0.0)
    hi = 1.0 - jnp.exp(-jnp.log(
        jnp.exp(-a * jnp.log1p(-x)) - jnp.log(interror) / M) / a)
    return logarea, x, lo, hi


def hmax2_log(a, M, N, K, iters: int = 50, relerror: float = 1e-12):
    """Fixed-point maximizer of the same representation (``hmax2``,
    ngg_integral.cpp:132-171): iterate
        u <- 1 / (1 + (M a (1-u)^-a - 1 - K a) / (N - 1)).
    The reference's hmax2 log-area omits the +log(a) term that hmax and
    umax carry (ngg_integral.cpp:161 vs 121); that makes its printed
    column differ by exactly log a, so we INCLUDE the term here to keep
    the four approximations directly comparable (the cross-check test
    asserts mutual agreement).

    Convergence domain: the map contracts only where
    a (1 + (K a + 1)/D*) < 1 with D* = M a (1-x*)^{-a} - K a - 1 -- the
    small-K regime.  Outside it the raw iteration leaves (0, 1) (the
    reference's own hmax2 prints diverging/nan iterates there,
    ngg_integral.cpp:148-150 -- it is the experimental variant); we clamp
    and damp the step, and return NaN when the final point is not a
    maximum (sigma <= 0), so out-of-domain calls fail loudly instead of
    returning a wrong area.  Use ``hmax_log``/``umax_log`` there."""
    a = jnp.asarray(a, jnp.result_type(float))
    M = jnp.asarray(M, a.dtype)
    N = jnp.asarray(N, a.dtype)
    K = jnp.asarray(K, a.dtype)
    shape = jnp.broadcast_shapes(a.shape, M.shape, N.shape, K.shape)

    def body(i, u):
        nxt = 1.0 / (1.0 + (M * a * jnp.exp(-a * jnp.log1p(-u))
                            - 1.0 - K * a) / jnp.maximum(N - 1.0, 1e-9))
        # the raw map can leave (0, 1) (it does for small N at a M <~ 1,
        # where the reference's loop prints diverging iterates and stops
        # on its relerror test); clamp + average to make it a contraction
        nxt = jnp.clip(nxt, 1e-9, 1.0 - 1e-9)
        return 0.5 * (u + nxt)

    u = jax.lax.fori_loop(0, iters, body, jnp.full(shape, 0.5, a.dtype))
    # converged iff u is a genuine fixed point (one more raw-map step
    # stays put) AND a maximum; else NaN (see docstring)
    resid = jnp.abs(1.0 / (1.0 + (M * a * jnp.exp(-a * jnp.log1p(-u))
                                  - 1.0 - K * a)
                           / jnp.maximum(N - 1.0, 1e-9)) - u)
    sigma = _ddh(u, a, M, N, K)
    area = (0.5 * jnp.log(2 * jnp.pi / jnp.abs(sigma))
            - _h(u, a, M, N, K) + K * jnp.log(M) + jnp.log(a))
    return jnp.where((sigma > 0) & (resid < 1e-5 * (u + 1e-3)), area,
                     jnp.nan)


def gmax_log(a, M, N, K, iters: int = 60):
    """Saddle point of the SECOND integral representation, x = t - M
    over [0, inf) (``gmax``, ngg_integral.cpp:173-243): Newton in
    u = log x with the reference's +-2u step clamp.

        g(x) = x - (K-1) log(1+x/M) - (N-1) log(1 - (1+x/M)^{-1/a})
        log area = 0.5 log(2 pi / sigma) - g + u + (K-1) log M - M,
        sigma = x^2 g'' + x g'.

    Independent of the [0,1] family (different contour), which is what
    makes the 4-way cross-check meaningful."""
    a = jnp.asarray(a, jnp.result_type(float))
    M = jnp.asarray(M, a.dtype)
    N = jnp.asarray(N, a.dtype)
    K = jnp.asarray(K, a.dtype)
    shape = jnp.broadcast_shapes(a.shape, M.shape, N.shape, K.shape)

    def g(x, pxm):
        return (x - (K - 1.0) * jnp.log1p(x / M)
                - (N - 1.0) * jnp.log(1.0 - 1.0 / pxm))

    def dg(x, pxm):
        return 1.0 - ((K - 1.0) + (N - 1.0) / a / (pxm - 1.0)) \
            / (1.0 + x / M) / M

    def ddg(x, pxm):
        return ((K - 1.0) + (N - 1.0) / a / (pxm - 1.0)
                + (N - 1.0) * pxm / a / a / (pxm - 1.0) ** 2) \
            / ((1.0 + x / M) * M) ** 2

    def body(i, u):
        eu = jnp.exp(u)
        pxm = jnp.exp(jnp.log1p(eu / M) / a)
        delta = eu * dg(eu, pxm) - 1.0
        dd = eu * eu * ddg(eu, pxm) + eu * dg(eu, pxm)
        step = delta / jnp.where(dd > 0, dd, 1.0)
        step = jnp.clip(step, -2.0 * jnp.abs(u), 2.0 * jnp.abs(u))
        return u - jnp.where(dd > 0, step, 0.0)

    # start at u = log(max(N - M, 0.5)): the mode of t ~ N sits near
    # x = N - M for large N (reference uses a warm-started chain)
    u0 = jnp.log(jnp.maximum(N - M, 0.5))
    u = jax.lax.fori_loop(0, iters, body, jnp.broadcast_to(u0, shape))
    eu = jnp.exp(u)
    pxm = jnp.exp(jnp.log1p(eu / M) / a)
    sigma = eu * eu * ddg(eu, pxm) + eu * dg(eu, pxm)
    return (0.5 * jnp.log(2 * jnp.pi / sigma) - g(eu, pxm) + u
            + (K - 1.0) * jnp.log(M) - M)


def ngg_quadrature_log(a, M, N, K, levels: int = 11):
    """Quadrature oracle: log of the exact s-integral the saddle points
    approximate (the ngg_integral.cpp:105-121 validation), computed with
    tanh-sinh on (0, 1)."""
    from . import quadrature
    a = jnp.asarray(a, jnp.result_type(float))
    M = jnp.asarray(M, a.dtype)
    N = jnp.asarray(N, a.dtype)
    K = jnp.asarray(K, a.dtype)

    def logf(s):
        omx = 1.0 - s
        return ((N[..., None] - 1) * jnp.log(s)
                - (1 + K[..., None] * a[..., None]) * jnp.log(omx)
                + M[..., None] * (1.0 - jnp.exp(
                    -a[..., None] * jnp.log(omx))))

    shape = jnp.broadcast_shapes(a.shape, M.shape, N.shape, K.shape)
    lo = jnp.full(shape, 1e-12)
    hi = jnp.full(shape, 1.0 - 1e-12)
    return (quadrature.tanh_sinh_log(logf, lo, hi, levels)
            + K * jnp.log(M) - M + jnp.log(a))
