"""Hierarchical PYP model: invariants + the b0->inf degenerate limit
(level-0 predictive -> H, so level 1 must match the flat PYP model)."""
import jax
import jax.numpy as jnp
import numpy as np

from libstb_jax.core import agrid
from libstb_jax.models import driver, hpyp, pyp


def test_invariants():
    data = pyp.crp_generate(0, 3, 10, 20, 0.5, 5.0)
    grid = agrid.make_grid(70, 30, g=32)
    cfg = hpyp.HPYPConfig(iters=40, hyper_cycle=0)
    out = hpyp.run_hpyp(jax.random.key(0), data, grid, 8,
                        0.5, 5.0, 0.5, 2.0, cfg)
    t1 = np.asarray(out["t1"])
    t0 = np.asarray(out["t0"])
    n0 = t1.sum(axis=1)
    assert (t1 <= data.n[None]).all() and (t1 >= (data.n > 0)[None]).all()
    assert (t0 <= n0).all()
    assert ((t0 >= 1) | (n0 == 0)).all()
    np.testing.assert_array_equal(np.asarray(out["T0"]), t0.sum(-1))
    np.testing.assert_array_equal(np.asarray(out["T1"]), t1.sum(-1))


def test_flat_limit_matches_pyp():
    data = pyp.crp_generate(1, 2, 10, 30, 0.5, 5.0)
    grid = agrid.make_grid(70, 35, g=48)
    C = 24
    cfgh = hpyp.HPYPConfig(iters=200, hyper_cycle=0)
    outh = hpyp.run_hpyp(jax.random.key(2), data, grid, C,
                         0.5, 5.0, 0.01, 2000.0, cfgh)
    cfgf = driver.GibbsConfig(iters=200, sampler="CT")
    outf = driver.run_gibbs(jax.random.key(3), data, grid, C,
                            0.5, 5.0, cfgf)
    Th = np.asarray(outh["T1ave"])          # (C, J)
    Tf = np.asarray(outf["Tave"])
    for j in range(Th.shape[1]):
        d = abs(Th[:, j].mean() - Tf[:, j].mean())
        se = np.hypot(Th[:, j].std(ddof=1), Tf[:, j].std(ddof=1)) / np.sqrt(C)
        assert d < 3 * se + 0.05, (j, Th[:, j].mean(), Tf[:, j].mean())
