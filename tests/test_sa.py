"""Explicit-SA oracle vs the scale samplers (check.c's multi-sampler
agreement methodology, check.c:98 / SURVEY.md §4.4): the explicit
seating-arrangement sampler is the exact baseline; HSA (its histogram
collapse) and CT must land on the same posterior mean table counts."""
import numpy as np
import jax
import jax.numpy as jnp

from libstb_jax.core import agrid
from libstb_jax.models import driver, pyp, sa


def test_sa_invariants():
    data = pyp.crp_generate(seed=5, n_groups=2, dim=5, n_per_group=20,
                            a=0.5, b=1.0)
    st = sa.sa_init(data)
    rng = np.random.default_rng(0)
    for _ in range(5):
        sa.sa_sweep(rng, st, 0.5, 1.0)
        t = st.t()
        # every customer stays seated; table counts within [1, n]
        for j in range(2):
            for i in range(5):
                assert st.sizes[j][i].sum() == data.n[j, i]
                if data.n[j, i] > 0:
                    assert 1 <= t[j, i] <= data.n[j, i]
        assert (st.T == t.sum(axis=1)).all()


def test_sa_agrees_with_hsa_and_ct():
    data = pyp.crp_generate(seed=11, n_groups=1, dim=5, n_per_group=30,
                            a=0.5, b=1.0)
    out_sa = sa.sa_run(data, iters=3000, a=0.5, b=1.0, seed=3)
    T_sa = float(out_sa["Tave"].sum())

    grid = agrid.make_grid(48, 36, g=100, dtype=jnp.float64)
    C = 256
    means = {}
    for name in ("HSA", "CT"):
        cfg = driver.GibbsConfig(iters=160, sampler=name)
        out = driver.run_gibbs(jax.random.key(4), data, grid, C,
                               0.5, 1.0, cfg)
        Tave = np.asarray(out["Tave"]).sum(axis=1)
        means[name] = (Tave.mean(), Tave.std() / np.sqrt(C))
    for name, (m, se) in means.items():
        assert abs(m - T_sa) < 6 * se + 0.15, (name, m, se, T_sa)
