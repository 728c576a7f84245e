"""SAMPLEA_M config-route discount sampler (samplea2 semantics):
bookkeeping invariants + stationary agreement with the grid-curve route
(the two-independent-algorithms criterion of check.c, SURVEY.md §4.4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libstb_jax.core import agrid
from libstb_jax.samplers import hyper


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(0)
    C, P = 8, 12
    ns = rng.integers(1, 30, size=(C, P)).astype(np.int32)
    ts = np.minimum(rng.integers(1, 6, size=(C, P)), ns).astype(np.int32)
    T = ts.sum(axis=1, keepdims=True).astype(np.float64)
    grid = agrid.make_grid(40, 12, g=48, dtype=jnp.float64)
    return ns, ts, T, grid


def test_config_sizes_sum_to_n(workload):
    ns, ts, T, grid = workload
    a = jnp.full((ns.shape[0],), 0.5)
    hist = hyper.sample_table_config(jax.random.key(0), grid,
                                     jnp.asarray(ns), jnp.asarray(ts), a,
                                     max_t=8, max_n=40)
    hist = np.asarray(hist)
    sizes = np.arange(hist.shape[1])
    # total mass: every active pair contributes all n customers; t==1
    # pairs contribute n; t==n pairs contribute nothing
    active = (ts > 1) & (ts < ns)
    t1 = ts == 1
    want = (ns * (active | t1)).sum(axis=1)
    got = (hist * sizes[None]).sum(axis=1) + (
        # size-1 tables of active pairs land in hist[1]; t==n pairs are
        # excluded entirely, so subtract nothing else
        0)
    np.testing.assert_array_equal(got.astype(int), want)


def test_config_table_counts(workload):
    ns, ts, T, grid = workload
    a = jnp.full((ns.shape[0],), 0.3)
    hist = np.asarray(hyper.sample_table_config(
        jax.random.key(1), grid, jnp.asarray(ns), jnp.asarray(ts), a,
        max_t=8, max_n=40))
    active = (ts > 1) & (ts < ns)
    t1 = ts == 1
    want_tables = (ts * active).sum(axis=1) + t1.sum(axis=1)
    np.testing.assert_array_equal(hist.sum(axis=1).astype(int), want_tables)


def test_stationary_agreement_with_grid_route():
    """Both routes must converge to the same posterior over a (they are
    marginal/auxiliary-variable versions of one posterior)."""
    rng = np.random.default_rng(3)
    C, P = 64, 16
    ns = rng.integers(2, 25, size=(P,)).astype(np.int32)
    ts = np.maximum(1, (ns * 0.4).astype(np.int32))
    nsb = np.broadcast_to(ns, (C, P)).copy()
    tsb = np.broadcast_to(ts, (C, P)).copy()
    T = np.full((C, 1), float(ts.sum()))
    b = np.full((C, 1), 5.0)
    grid = agrid.make_grid(32, 12, g=64, dtype=jnp.float64)

    def run(route, key):
        a = jnp.full((C,), 0.5, jnp.float64)
        for i in range(15):
            key, k = jax.random.split(key)
            if route == "grid":
                a, _ = hyper.sample_a(k, a, grid, jnp.asarray(ns),
                                      jnp.asarray(ts), jnp.asarray(T),
                                      jnp.asarray(b))
            else:
                a, _ = hyper.sample_a_m(k, a, grid, jnp.asarray(nsb),
                                        jnp.asarray(tsb), jnp.asarray(T),
                                        jnp.asarray(b), max_t=12, max_n=32)
        return np.asarray(a)

    a_grid = run("grid", jax.random.key(10))
    a_m = run("m", jax.random.key(20))
    se = np.sqrt(a_grid.var() / C + a_m.var() / C)
    assert abs(a_grid.mean() - a_m.mean()) < 3 * se + 0.01, (
        a_grid.mean(), a_m.mean(), se)