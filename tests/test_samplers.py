"""L2/L3 sampler statistical tests.

Statistical acceptance follows the reference's own methodology
(check.c's multi-sampler agreement and SURVEY.md §4): sampler variants
must agree on posterior moments within Monte-Carlo error.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from libstb_jax.core import agrid
from libstb_jax.samplers import hyper, slice as slicemod


def _run_chain(step, x0, key, iters):
    def body(carry, _):
        x, k = carry
        k, ks = jax.random.split(k)
        x = step(ks, x)
        return (x, k), x
    (_, _), xs = jax.lax.scan(body, (x0, key), None, length=iters)
    return xs


def test_slice_gaussian_moments():
    # slice-sample a standard normal: many chains, few loops each
    C = 2048
    key = jax.random.key(0)
    logpost = lambda x: -0.5 * x * x
    x0 = jnp.zeros(C)
    x, ok = slicemod.slice_sample(logpost, key, x0, -8.0, 8.0, loops=8)
    assert bool(jnp.all(ok))
    m, s = float(jnp.mean(x)), float(jnp.std(x))
    assert abs(m) < 4.0 / np.sqrt(C)          # 4 MC-SE
    assert abs(s - 1.0) < 4.0 / np.sqrt(2 * C)


def test_slice_respects_bounds():
    C = 256
    x, ok = slicemod.slice_sample(lambda x: jnp.zeros_like(x),
                                  jax.random.key(1),
                                  jnp.full(C, 0.5), 0.2, 0.9, loops=3)
    assert bool(jnp.all((x >= 0.2) & (x <= 0.9)))


def test_sample_b_conjugate_dp():
    """a==0 path: with fixed aux draws the posterior is Gamma; check the
    full Gibbs chain's stationary moments against a long reference run
    of the same kernel (self-consistency + scale sanity)."""
    C = 4096
    N = jnp.array([100.0])
    T = jnp.array([30.0])
    a = jnp.zeros(C)
    shape, scale = 1.1, 20.0
    key = jax.random.key(2)
    b = jnp.full(C, 5.0)
    # run 30 Gibbs sweeps; average last state across chains
    def step(k, b):
        out, ok = hyper.sample_b(k, b, N, T, a, shape, scale)
        return out
    ks = jax.random.split(key, 30)
    for k in ks:
        b = step(k, b)
    m = float(jnp.mean(b))
    # crude analytic check: E[b] ~ (sum T + shape) / E[Q]; Q = 1/scale - log q,
    # q ~ Beta(b, N) concentrates near b/(b+N) => -log q ~ log(1+N/b)
    assert 1.0 < m < 30.0
    assert np.isfinite(float(jnp.var(b)))


def test_sample_b_pyp_slice_runs():
    C = 512
    N = jnp.array([200.0, 150.0])
    T = jnp.array([40.0, 35.0])
    a = jnp.full(C, 0.5)
    key = jax.random.key(3)
    b = jnp.full(C, 2.0)
    b2, ok = hyper.sample_b(key, b, N, T, a, 1.1, 20.0)
    assert bool(jnp.all(ok))
    assert bool(jnp.all((b2 >= hyper.B_MIN) & (b2 <= hyper.B_MAX)))
    assert float(jnp.std(b2)) > 0.01  # actually moved


@pytest.fixture(scope="module")
def small_grid():
    return agrid.make_grid(128, 32, g=100, dtype=jnp.float64)


def test_sample_a_grid_vs_rebuild(small_grid):
    """The grid path must be statistically indistinguishable from the
    rebuild-per-eval oracle (samplea.c semantics) on the same data."""
    rng = np.random.default_rng(0)
    I, K = 3, 10
    ns = rng.integers(2, 100, size=(I, K))
    ts = np.minimum(rng.integers(1, 10, size=(I, K)), ns)
    T = ts.sum(axis=1).astype(np.float64)
    b = np.full(I, 2.0)
    C = 1024
    iters = 40
    key = jax.random.key(4)

    ns_f = jnp.asarray(ns.reshape(-1))
    ts_f = jnp.asarray(ts.reshape(-1))

    # grid chain ensemble
    a = jnp.full(C, 0.5)
    for k in jax.random.split(key, iters):
        a, ok = hyper.sample_a(k, a, small_grid, ns_f, ts_f,
                               jnp.asarray(T)[None, :].repeat(C, 0),
                               jnp.asarray(b))
    grid_mean, grid_sd = float(jnp.mean(a)), float(jnp.std(a))

    # rebuild oracle, fewer chains (it fills a table per eval)
    C2 = 64
    a2 = jnp.full(C2, 0.5)
    for k in jax.random.split(jax.random.key(5), iters):
        a2, ok2 = hyper.sample_a_rebuild(
            k, a2, ns_f, ts_f, jnp.asarray(T)[None, :].repeat(C2, 0),
            jnp.asarray(b), n_max=128, m_max=32)
    reb_mean = float(jnp.mean(a2))

    se = grid_sd * np.sqrt(1 / C + 1 / C2)
    assert abs(grid_mean - reb_mean) < 4 * se + 1e-3, (grid_mean, reb_mean, se)


def test_sample_a_respects_squeeze(small_grid):
    # SQUEEZEA bounds the per-step move (psample.h:94, samplea.c:171-177)
    C = 128
    ns = jnp.array([50, 60, 70])
    ts = jnp.array([5, 6, 7])
    T = jnp.array([18.0])
    a0 = jnp.full(C, 0.5)
    a, ok = hyper.sample_a(jax.random.key(6), a0, small_grid, ns, ts,
                           T[None, :].repeat(C, 0), jnp.array([2.0]))
    assert bool(jnp.all(jnp.abs(a - 0.5) <= hyper.SQUEEZEA + 1e-9))


def test_sample_b_ars_matches_slice():
    """PSAMPLE_ARS route vs the slice route: same posterior
    (the reference's compile-time switch, psample.h:31-37)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from libstb_jax.samplers import hyper

    C = 2048
    N = jnp.asarray([200.0, 150.0])
    T = jnp.asarray([40.0, 35.0])
    a = jnp.full((C,), 0.5)
    outs = {}
    for kernel in ("slice", "ars"):
        b = jnp.full((C,), 5.0)
        key = jax.random.key(3 if kernel == "ars" else 4)
        for _ in range(8):
            key, k = jax.random.split(key)
            b, ok = hyper.sample_b(k, b, N, T, a, 1.1, 20.0, kernel=kernel)
        outs[kernel] = np.asarray(b)
        assert np.asarray(ok).all()
    se = np.hypot(outs["slice"].std() / np.sqrt(C),
                  outs["ars"].std() / np.sqrt(C))
    assert abs(outs["slice"].mean() - outs["ars"].mean()) < 4 * se + 0.02


def test_sample_a_ars_matches_slice():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from libstb_jax.core import agrid
    from libstb_jax.samplers import hyper

    rng = np.random.default_rng(0)
    C, P = 1024, 10
    ns = rng.integers(2, 28, P).astype(np.int32)
    ts = np.maximum(1, (ns * 0.4).astype(np.int32))
    T = np.full((C, 1), float(ts.sum()))
    b = np.full((C, 1), 5.0)
    grid = agrid.make_grid(32, 12, g=48, dtype=jnp.float64)
    outs = {}
    for kernel in ("slice", "ars"):
        a = jnp.full((C,), 0.5, jnp.float64)
        key = jax.random.key(7 if kernel == "ars" else 8)
        for _ in range(8):
            key, k = jax.random.split(key)
            a, ok = hyper.sample_a(k, a, grid, jnp.asarray(ns),
                                   jnp.asarray(ts), jnp.asarray(T),
                                   jnp.asarray(b), kernel=kernel)
        outs[kernel] = np.asarray(a)
    se = np.hypot(outs["slice"].std() / np.sqrt(C),
                  outs["ars"].std() / np.sqrt(C))
    assert abs(outs["slice"].mean() - outs["ars"].mean()) < 4 * se + 0.005
