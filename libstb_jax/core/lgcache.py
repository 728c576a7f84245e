"""Fast lgamma/digamma difference helpers.

The reference caches scalar calls in little memo tables (lib/lgamma.c:30-114
``gcache``/``pcache``/``qcache``) and Taylor-expands around integer nodes
(lib/lgamma.c:143-240 ``gammadiff``/``psidiff``) because scalar lgamma is
expensive on CPU.  On an accelerator the idiomatic equivalents are (a) fully fused
vectorised expressions, and (b) *precomputed arrays* over the integer index
-- one lgamma sweep amortised over every later gather -- which is what the
samplers here consume.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import special

__all__ = ["gammadiff", "psidiff", "qval", "gcache_table", "pcache_table",
           "qcache_table"]


def gammadiff(n, alpha):
    """lgamma(n + alpha) - lgamma(alpha) with exact small-n products
    (lgamma.c:143-157): n<=3 evaluated as log(alpha (1+alpha) ...) which
    avoids the cancellation of subtracting two lgammas near alpha ~ 0."""
    n = jnp.asarray(n)
    alpha = jnp.asarray(alpha, jnp.result_type(float))
    direct = jax.lax.lgamma(n.astype(alpha.dtype) + alpha) - jax.lax.lgamma(alpha)
    p1 = jnp.log(alpha)
    p2 = jnp.log(alpha * (1.0 + alpha))
    p3 = jnp.log(alpha * (1.0 + alpha) * (2.0 + alpha))
    out = jnp.where(n <= 0, jnp.zeros((), alpha.dtype),
          jnp.where(n == 1, p1,
          jnp.where(n == 2, p2,
          jnp.where(n == 3, p3, direct))))
    return out


def psidiff(n, alpha):
    """digamma(n + alpha) - digamma(alpha) with exact small-n sums
    (lgamma.c:194-209)."""
    n = jnp.asarray(n)
    alpha = jnp.asarray(alpha, jnp.result_type(float))
    direct = special.digamma(n.astype(alpha.dtype) + alpha) - special.digamma(alpha)
    s1 = 1.0 / alpha
    s2 = s1 + 1.0 / (1.0 + alpha)
    s3 = s2 + 1.0 / (2.0 + alpha)
    return jnp.where(n <= 0, jnp.zeros((), alpha.dtype),
           jnp.where(n == 1, s1,
           jnp.where(n == 2, s2,
           jnp.where(n == 3, s3, direct))))


def qval(a, n):
    """S^{n+1}_{2,a} / S^{n+1}_{1,a}  (lgamma.c:92-97).

    NOTE: the reference's comment (lgamma.c:88) says /S^n_{1,a}, but its
    code and its exact small-j cache values (lgamma.c:105-109, e.g.
    j=1 -> 1/(1-a) = S^2_2/S^2_1) both compute the same-n ratio; we match
    the code.  a<0.02: digamma(n+1-a)-digamma(1-a); else
    (1 - Gamma(n+1-2a)Gamma(1-a)/(Gamma(n+1-a)Gamma(1-2a)))/a."""
    a = jnp.asarray(a, jnp.result_type(float))
    n = jnp.asarray(n).astype(a.dtype)
    small = special.digamma(n + 1.0 - a) - special.digamma(1.0 - a)
    safe_a = jnp.where(a >= 0.02, a, 1.0)
    lga0 = jax.lax.lgamma(1.0 - 2.0 * safe_a) - jax.lax.lgamma(1.0 - safe_a)
    big = (1.0 - jnp.exp(jax.lax.lgamma(n + 1.0 - 2.0 * safe_a)
                         - jax.lax.lgamma(n + 1.0 - safe_a) - lga0)) / safe_a
    return jnp.where(a < 0.02, small, big)


def gcache_table(p, jmax: int):
    """Array cache: out[j] = lgamma(j+p) - lgamma(p) for j = 0..jmax-1.

    The vectorised successor of gcache_init/gcache_value (lgamma.c:30-52);
    build once per density sweep, then use cheap gathers."""
    j = jnp.arange(jmax)
    return gammadiff(j, p)


def pcache_table(p, jmax: int):
    """Array cache of digamma diffs (lgamma.c:54-76)."""
    j = jnp.arange(jmax)
    return psidiff(j, p)


def qcache_table(a, jmax: int):
    """Array cache of qval with the exact small-j closed forms
    (lgamma.c:98-114): j=1 -> 1/(1-a); j=2 -> 3/(2-a);
    j=3 -> (11-7a)/((3-a)(2-a))."""
    a = jnp.asarray(a, jnp.result_type(float))
    j = jnp.arange(jmax)
    gen = qval(a, j)
    e1 = 1.0 / (1.0 - a)
    e2 = 3.0 / (2.0 - a)
    e3 = (11.0 - 7.0 * a) / (3.0 - a) / (2.0 - a)
    return jnp.where(j == 0, jnp.zeros((), a.dtype),
           jnp.where(j == 1, e1,
           jnp.where(j == 2, e2,
           jnp.where(j == 3, e3, gen))))
