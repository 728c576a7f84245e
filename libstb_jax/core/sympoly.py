"""Elementary symmetric polynomials and the exact choose-H sampler.

Reproduces the capabilities of lib/sympoly.c:

* ``sympoly`` -- e_h(x_0..x_{K-1}) for h = 0..H (sympoly.c:60-110).  The
  reference runs the linear recursion with an overflow-rescaling
  accumulator; here the whole computation lives in log space
  (``logaddexp``), which is unconditionally stable and vectorises: the
  update for all h at once is one shifted add per item, so the scan body
  is two elementwise ops.

* ``sympoly_sample`` -- draw a subset of exactly H of K features with
  probability proportional to the product of the selected weights
  (sympoly.c:129-239: forward DP table + backward pass).  The result is a
  boolean mask of shape (K,) rather than the reference's 32-bit bitmask,
  which removes the H<=31 limit (sympoly.h:66-70) and vmaps over chains.

Identities used by tests: e_h(1,...,1) = C(K,h); sum_h e_h z^h =
prod_k (1 + z x_k).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["sympoly", "sympoly_sample", "SYMPOLY_MAX"]

# the reference caps H at 10 by default (sympoly.h:39); ours is soft.
SYMPOLY_MAX = 10


def sympoly(logx, h_max: int):
    """log e_h for h = 0..h_max over the trailing axis of ``logx``.

    Args:
      logx: (..., K) log-weights (use -inf for absent features).
      h_max: largest subset size.
    Returns:
      (..., h_max+1) array of log e_h; log e_0 = 0.
    """
    logx = jnp.asarray(logx)
    batch = logx.shape[:-1]
    K = logx.shape[-1]
    dt = logx.dtype
    init = jnp.full(batch + (h_max + 1,), -jnp.inf, dt)
    init = init.at[..., 0].set(0.0)

    def step(le, lx):
        shifted = jnp.concatenate(
            [jnp.full(batch + (1,), -jnp.inf, dt), le[..., :-1]], axis=-1)
        return jnp.logaddexp(le, lx[..., None] + shifted), None

    le, _ = jax.lax.scan(step, init, jnp.moveaxis(logx, -1, 0))
    return le


def _forward_tables(logx, h_max: int):
    """All prefix DP rows: F[k, h] = log e_h(x_0..x_{k-1}) (sympoly.c:129-
    207 builds the same table row by row)."""
    logx = jnp.asarray(logx)
    batch = logx.shape[:-1]
    dt = logx.dtype
    init = jnp.full(batch + (h_max + 1,), -jnp.inf, dt)
    init = init.at[..., 0].set(0.0)

    def step(le, lx):
        shifted = jnp.concatenate(
            [jnp.full(batch + (1,), -jnp.inf, dt), le[..., :-1]], axis=-1)
        new = jnp.logaddexp(le, lx[..., None] + shifted)
        return new, le          # emit the row BEFORE item k is included

    last, prefix = jax.lax.scan(step, init, jnp.moveaxis(logx, -1, 0))
    return last, prefix          # prefix[k] = table over x_0..x_{k-1}


def sympoly_sample(key, logx, h: int):
    """Sample a size-``h`` subset with P(mask) ∝ prod_{k in mask} x_k.

    Exact backward pass on the DP table (sympoly.c:215-239): walk items
    K-1..0; include item k with probability
    x_k e_{r-1}(x_<k) / e_r(x_<=k) where r = remaining picks.

    Args:
      key: PRNG key; logx: (..., K) log weights; h: subset size (static).
    Returns:
      (..., K) boolean mask with exactly h True per batch entry
      (fewer only if fewer than h weights are finite).
    """
    logx = jnp.asarray(logx)
    batch = logx.shape[:-1]
    K = logx.shape[-1]
    dt = logx.dtype
    last, prefix = _forward_tables(logx, h)
    # walk k = K-1 .. 0; state: remaining r, current table = e(x_<=k)
    us = jax.random.uniform(key, (K,) + batch, dt)

    def step(carry, inp):
        r = carry                      # (...,) int32 remaining picks
        lx, row_before, u = inp        # row_before = e(x_<k)
        ri = jnp.clip(r, 0, h)
        # log P(include) = lx + e_{r-1}(x_<k) - e_r(x_<=k)
        num = lx + jnp.take_along_axis(
            row_before, jnp.maximum(ri - 1, 0)[..., None], axis=-1)[..., 0]
        # e_r(x_<=k) = logaddexp(e_r(x_<k), lx + e_{r-1}(x_<k))
        den = jnp.logaddexp(
            jnp.take_along_axis(row_before, ri[..., None], axis=-1)[..., 0],
            num)
        p = jnp.exp(num - den)
        take = (u < p) & (r > 0)
        return r - take.astype(r.dtype), take

    r0 = jnp.full(batch, h, jnp.int32)
    lxs = jnp.moveaxis(logx, -1, 0)
    _, takes = jax.lax.scan(
        step, r0, (lxs[::-1], prefix[::-1], us), reverse=False)
    return jnp.moveaxis(takes[::-1], 0, -1)
