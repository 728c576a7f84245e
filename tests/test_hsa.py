"""HSA (histogrammed seating arrangements) sampler: bookkeeping
invariants + posterior agreement with CT (check.c's five-sampler
equivalence criterion)."""
import jax
import jax.numpy as jnp
import numpy as np

from libstb_jax.core import agrid
from libstb_jax.models import driver, pyp


def _data():
    return pyp.crp_generate(0, 2, 12, 30, 0.5, 5.0)


def test_invariants_preserved():
    data = _data()
    C = 8
    hist, T = pyp.init_hsa(data, C)
    a = jnp.full((C,), 0.5)
    b = jnp.full((C,), 5.0)
    key = jax.random.key(0)
    for r in range(3):
        key, k = jax.random.split(key)
        hist, T = pyp.hsa_sweep(k, hist, T, a, b, data)
    hist = np.asarray(hist)
    sizes = np.arange(hist.shape[-1])
    # customers conserved per (group, category)
    np.testing.assert_array_equal((hist * sizes).sum(-1),
                                  np.broadcast_to(data.n, hist.shape[:-1]))
    # T = total tables per group
    np.testing.assert_array_equal(hist.sum(-1).sum(-1), np.asarray(T))
    # at least one table per occupied category
    assert ((hist.sum(-1) >= 1) | (data.n == 0)[None]).all()


def test_hsa_matches_ct_posterior():
    data = pyp.crp_generate(1, 1, 15, 40, 0.5, 10.0)
    grid = agrid.make_grid(44, 44, g=48)
    means = {}
    for s in ["CT", "HSA"]:
        cfg = driver.GibbsConfig(iters=240, sampler=s)
        out = driver.run_gibbs(jax.random.key(2), data, grid, 24,
                               0.5, 10.0, cfg)
        Tave = np.asarray(out["Tave"])[:, 0]
        means[s] = (Tave.mean(), Tave.std(ddof=1) / np.sqrt(len(Tave)))
    diff = abs(means["CT"][0] - means["HSA"][0])
    band = 3 * np.hypot(means["CT"][1], means["HSA"][1]) + 0.05
    assert diff < band, (means, band)
