"""Tanh-sinh (double-exponential) quadrature.

The independent-oracle capability of test/DEIntegrator.h (John D. Cook's
integrator, used by test/ngg_integral.cpp:105-121 to validate the NGG
saddle-point approximations).  Implemented from the published
Takahasi-Mori construction -- x = tanh((pi/2) sinh t) on a fixed level-L
trapezoid grid -- rather than from the reference's precomputed-constant
headers (which carry an attribution requirement, README:204-207).

Vectorised: all abscissae evaluate in one call of the (batched) integrand,
so the oracle itself runs fine on the device, though its main use is f64 CPU
validation in tests.
"""
from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
import numpy as np

__all__ = ["tanh_sinh", "tanh_sinh_log"]


def _nodes(levels: int, dtype=np.float64):
    """Abscissae x in (-1, 1) and weights w for the tanh-sinh rule."""
    h = 1.0 / (1 << (levels - 1))
    # |t| beyond ~6.1 underflows the double-exponential weight in f64
    tmax = 6.1
    t = np.arange(-tmax, tmax + h / 2, h, dtype=np.float64)
    st = 0.5 * np.pi * np.sinh(t)
    x = np.tanh(st)
    w = h * 0.5 * np.pi * np.cosh(t) / np.cosh(st) ** 2
    keep = (np.abs(x) < 1.0) & (w > 0)
    return x[keep].astype(dtype), w[keep].astype(dtype)


def tanh_sinh(f: Callable, a, b, levels: int = 10):
    """integral_a^b f(x) dx; ``f`` must accept a vector of abscissae.

    ``a``/``b`` may be arrays (batched intervals); then f receives
    (..., P) and the result is (...,).
    """
    x, w = _nodes(levels)
    a = jnp.asarray(a, jnp.result_type(float))
    b = jnp.asarray(b, a.dtype)
    mid = 0.5 * (a + b)
    half = 0.5 * (b - a)
    xs = mid[..., None] + half[..., None] * x
    return half * jnp.sum(f(xs) * w, axis=-1)


def tanh_sinh_log(logf: Callable, a, b, levels: int = 10):
    """log integral_a^b exp(logf(x)) dx, stable for peaked integrands."""
    x, w = _nodes(levels)
    a = jnp.asarray(a, jnp.result_type(float))
    b = jnp.asarray(b, a.dtype)
    mid = 0.5 * (a + b)
    half = 0.5 * (b - a)
    xs = mid[..., None] + half[..., None] * x
    ly = logf(xs) + jnp.log(w)
    m = jnp.max(ly, axis=-1, keepdims=True)
    s = jnp.sum(jnp.exp(ly - m), axis=-1)
    return jnp.log(half) + m[..., 0] + jnp.log(s)
