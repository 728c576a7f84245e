"""L0 scalar special functions, vectorised for device execution.

Reproduces the numerical capabilities of the reference's L0 layer
(``lib/digamma.c:31-48``, ``lib/digammainv.c:27-38``, ``lib/polygamma.c``
wrappers, and the log-space helpers of ``lib/stable.c:95-103`` /
``lib/samplea.c:233-239``) as branch-free jnp expressions: the reference's
scalar ``while (x<=5)`` recurrences become fixed-trip masked shifts so the
whole family vmaps/shards cleanly and fuses into elementwise kernels.

All functions preserve the dtype of their inputs (f32 on the GPU, f64
under x64 on CPU for oracle tests).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "logadd",
    "logdiff",
    "log1mexp",
    "digamma",
    "trigamma",
    "tetragamma",
    "pentagamma",
    "digamma_inv",
    "lgamma",
]

lgamma = jax.lax.lgamma

# Number of masked recurrence steps used to shift arguments above the
# asymptotic-series threshold.  The smallest argument produced by the
# samplers is ~A_MIN=0.01 (psample.h:89), so ceil(ASYMPT_MIN - 0.01) steps
# suffice.
_SHIFT_STEPS = 10
_ASYMPT_MIN = 8.0

# Bernoulli numbers B_2, B_4, ..., B_14 for the polygamma asymptotic tails.
_B2K = (1.0 / 6.0, -1.0 / 30.0, 1.0 / 42.0, -1.0 / 30.0,
        5.0 / 66.0, -691.0 / 2730.0, 7.0 / 6.0)


def _bern_tail(f, coeffs):
    """Horner evaluation of sum_k c_k f^k for f = 1/y^2 (c_1 first)."""
    acc = 0.0
    for c in reversed(coeffs):
        acc = f * (c + acc)
    return acc


def logadd(x, y):
    """log(exp(x) + exp(y)), the reference's ``logadd`` (stable.c:95-103).

    jnp.logaddexp already implements the max/deflate trick; -inf inputs are
    handled (logaddexp(-inf, -inf) == -inf without nan).
    """
    return jnp.logaddexp(x, y)


def logdiff(x, y):
    """log(exp(x) - exp(y)) for x >= y, cf. ``logminus`` (samplea.c:233-239).

    Returns -inf where y >= x (the reference's convention).  Uses the
    far-tail linearisation exp(y-x) ~ 0 => x + log1p(-exp(y-x)) which is the
    numerically stable form for all y < x.
    """
    x, y = jnp.asarray(x), jnp.asarray(y)
    d = y - x
    # log1p(-exp(d)) for d<0: use expm1 form when d > -log(2) for accuracy.
    small = d > -0.6931471805599453
    safe_d = jnp.where(small, jnp.minimum(d, -jnp.finfo(x.dtype).tiny), d)
    val = jnp.where(
        small,
        jnp.log(-jnp.expm1(safe_d)),
        jnp.log1p(-jnp.exp(d)),
    )
    return jnp.where(d < 0, x + val, -jnp.inf)


def log1mexp(d):
    """log(1 - exp(d)) for d <= 0, stable in both tails."""
    d = jnp.asarray(d)
    small = d > -0.6931471805599453
    safe_d = jnp.where(small, jnp.minimum(d, -jnp.finfo(d.dtype).tiny), d)
    return jnp.where(
        small,
        jnp.log(-jnp.expm1(safe_d)),
        jnp.log1p(-jnp.exp(d)),
    )


def _shift_mask(x):
    """Masked upward recurrence shift: returns (y, js) where y = x + k with
    y >= _ASYMPT_MIN and js enumerates the shifted-out points x, x+1, ...

    Branch-free replacement for the reference's ``while (x<=5)`` loop
    (digamma.c:37-40).
    """
    j = jnp.arange(_SHIFT_STEPS, dtype=x.dtype)
    xj = x[..., None] + j  # (..., S)
    mask = xj < _ASYMPT_MIN
    k = jnp.sum(mask, axis=-1).astype(x.dtype)
    return x + k, xj, mask


def digamma(x):
    """psi(x) via recurrence + asymptotic series (digamma.c:31-48 semantics).

    Valid for x > 0; vectorised and branch-free.
    """
    x = jnp.asarray(x)
    y, xj, mask = _shift_mask(x)
    r = -jnp.sum(jnp.where(mask, 1.0 / xj, 0.0), axis=-1)
    f = 1.0 / (y * y)
    # psi(y) ~ log y - 1/(2y) - sum_k B_{2k}/(2k) y^{-2k}
    t = -_bern_tail(f, [b / (2.0 * (k + 1)) for k, b in enumerate(_B2K)])
    return r + jnp.log(y) - 0.5 / y + t


def trigamma(x):
    """psi'(x) for x > 0 (polygamma.c MLtrigamma capability)."""
    x = jnp.asarray(x)
    y, xj, mask = _shift_mask(x)
    r = jnp.sum(jnp.where(mask, 1.0 / (xj * xj), 0.0), axis=-1)
    f = 1.0 / (y * y)
    # psi'(y) ~ 1/y + 1/(2y^2) + sum_k B_{2k} y^{-2k-1}
    t = (1.0 / y) * (1.0 + _bern_tail(f, list(_B2K))) + 0.5 * f
    return r + t


def tetragamma(x):
    """psi''(x) for x > 0 (polygamma.c MLtetragamma capability)."""
    x = jnp.asarray(x)
    y, xj, mask = _shift_mask(x)
    r = -2.0 * jnp.sum(jnp.where(mask, 1.0 / (xj * xj * xj), 0.0), axis=-1)
    f = 1.0 / (y * y)
    # psi''(y) ~ -1/y^2 - 1/y^3 - sum_k (2k+1) B_{2k} y^{-2k-2}
    t = -f * (1.0 + 1.0 / y
              + _bern_tail(f, [(2 * (k + 1) + 1) * b for k, b in enumerate(_B2K)]))
    return r + t


def pentagamma(x):
    """psi'''(x) for x > 0 (polygamma.c MLpentagamma capability)."""
    x = jnp.asarray(x)
    y, xj, mask = _shift_mask(x)
    x4 = xj * xj
    x4 = x4 * x4
    r = 6.0 * jnp.sum(jnp.where(mask, 1.0 / x4, 0.0), axis=-1)
    f = 1.0 / (y * y)
    y3 = 1.0 / (y * y * y)
    # psi'''(y) ~ 2/y^3 + 3/y^4 + sum_k (2k+1)(2k+2) B_{2k} y^{-2k-3}
    t = y3 * (2.0 + 3.0 / y + _bern_tail(
        f, [(2 * (k + 1) + 1) * (2 * (k + 1) + 2) * b for k, b in enumerate(_B2K)]))
    return r + t


def digamma_inv(x, iters: int = 5):
    """Inverse digamma via Minka's Newton iteration (digammainv.c:27-38).

    guess = -1/(x - psi(1)) for x < -2.22 else exp(x) + 0.5, then
    ``iters`` Newton steps  guess -= (psi(guess) - x)/psi'(guess).
    """
    x = jnp.asarray(x)
    neg_euler = -0.5772156649015329  # digamma(1)
    guess = jnp.where(x < -2.22, -1.0 / (x - neg_euler), jnp.exp(x) + 0.5)

    def body(_, g):
        return g - (digamma(g) - x) / trigamma(g)

    return jax.lax.fori_loop(0, iters, body, guess)
