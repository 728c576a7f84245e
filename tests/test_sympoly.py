"""sympoly: identities, oracle values, and sampler exactness
(reference: lib/sympoly.c self-test semantics, sympoly.c:246-295)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libstb_jax.core import sympoly


def esp_exact(x, h):
    """Brute-force elementary symmetric polynomial."""
    return sum(np.prod(c) for c in itertools.combinations(x, h)) if h else 1.0


def test_sympoly_binomial():
    # e_h(1,...,1) = C(K, h)
    from scipy.special import comb
    K, H = 12, 6
    le = sympoly.sympoly(jnp.zeros((K,), jnp.float64), H)
    want = np.log([comb(K, h, exact=True) for h in range(H + 1)])
    np.testing.assert_allclose(np.asarray(le), want, rtol=1e-12)


def test_sympoly_random_oracle():
    rng = np.random.default_rng(0)
    x = rng.gamma(1.0, 5.0, size=9)
    le = sympoly.sympoly(jnp.log(jnp.asarray(x)), 5)
    want = np.log([esp_exact(x, h) for h in range(6)])
    np.testing.assert_allclose(np.asarray(le), want, rtol=1e-10)


def test_sympoly_batched():
    rng = np.random.default_rng(1)
    x = rng.gamma(1.0, 1.0, size=(4, 7))
    le = sympoly.sympoly(jnp.log(jnp.asarray(x)), 3)
    assert le.shape == (4, 4)
    for b in range(4):
        want = np.log([esp_exact(x[b], h) for h in range(4)])
        np.testing.assert_allclose(np.asarray(le[b]), want, rtol=1e-10)


def test_sympoly_inf_weights():
    # -inf (zero weight) entries never contribute
    x = np.array([1.0, 2.0, 3.0])
    lx = jnp.asarray(np.log(np.array([1.0, 2.0, 3.0, 0.0, 0.0])))
    le = sympoly.sympoly(lx, 3)
    want = np.log([esp_exact(x, h) for h in range(4)])
    np.testing.assert_allclose(np.asarray(le), want, rtol=1e-10)


def test_sample_exact_distribution():
    """Sampler matches the exact subset distribution (chi-square-free:
    compare frequencies within 5 sigma)."""
    rng = np.random.default_rng(2)
    K, H = 6, 3
    x = rng.gamma(1.0, 2.0, size=K)
    subsets = list(itertools.combinations(range(K), H))
    probs = np.array([np.prod(x[list(s)]) for s in subsets])
    probs /= probs.sum()

    n = 4000
    keys = jax.random.split(jax.random.key(0), n)
    lx = jnp.log(jnp.asarray(x))
    masks = jax.vmap(lambda k: sympoly.sympoly_sample(k, lx, H))(keys)
    masks = np.asarray(masks)
    assert (masks.sum(axis=1) == H).all()
    counts = {}
    for m in masks:
        counts[tuple(np.nonzero(m)[0])] = counts.get(tuple(np.nonzero(m)[0]), 0) + 1
    for s, p in zip(subsets, probs):
        c = counts.get(s, 0)
        se = np.sqrt(n * p * (1 - p))
        assert abs(c - n * p) < 5 * se + 3, (s, c, n * p)


def test_sample_batched_shapes():
    lx = jnp.log(jax.random.uniform(jax.random.key(1), (5, 8)) + 0.1)
    m = sympoly.sympoly_sample(jax.random.key(2), lx, 4)
    assert m.shape == (5, 8)
    assert (np.asarray(m).sum(axis=1) == 4).all()
