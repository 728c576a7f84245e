"""End-to-end checkpoint/resume of a Gibbs ensemble + trace diagnostics
(the aux-subsystem capabilities the reference lacks, SURVEY.md §5.4)."""
import jax
import jax.numpy as jnp
import numpy as np

from libstb_jax.core import agrid
from libstb_jax.models import driver, pyp
from libstb_jax.utils import checkpoint


def test_gibbs_checkpoint_resume(tmp_path):
    data = pyp.crp_generate(0, 1, 12, 25, 0.5, 5.0)
    grid = agrid.make_grid(30, 27, g=32)
    cfg = driver.GibbsConfig(iters=40, burnin=1, bcycle=2, acycle=5)
    out = driver.run_gibbs(jax.random.key(0), data, grid, 8, 0.5, 5.0, cfg)

    state = {"t": out["t"], "T": out["T"], "a": out["a"], "b": out["b"],
             "key": jax.random.key(99)}
    p = checkpoint.save(str(tmp_path / "run"), state,
                        meta={"iters_done": 40, "a_grid": [30, 27, 32]})
    loaded, meta = checkpoint.load(p, like=state)
    assert meta["iters_done"] == 40
    np.testing.assert_array_equal(np.asarray(loaded["t"]),
                                  np.asarray(out["t"]))

    # continue the chain from the restored state: hand the restored t/T
    # in as the init by rebuilding through the jitted inner runner
    t2 = jnp.asarray(loaded["t"])
    T2 = jnp.asarray(loaded["T"])
    out2 = driver._run_gibbs_jit(
        loaded["key"], data, grid, t2, T2, None,
        jnp.asarray(loaded["a"]), jnp.asarray(loaded["b"]),
        chains=8, cfg=cfg, tmax=int(data.n.max()) + 1, burnin=1)
    assert np.isfinite(np.asarray(out2["Tave_mean"])).all()


def test_collect_traces_diagnostics():
    data = pyp.crp_generate(1, 1, 10, 20, 0.5, 5.0)
    grid = agrid.make_grid(24, 21, g=24)
    cfg = driver.GibbsConfig(iters=60, burnin=10, bcycle=1, acycle=1,
                             collect_traces=True)
    out = driver.run_gibbs(jax.random.key(1), data, grid, 8, 0.5, 5.0, cfg)
    assert out["a_trace"].shape == (60, 8)
    assert np.isfinite(float(out["a_rhat"]))
    assert 0 < float(out["b_ess"]) <= 60 * 8 * 1.5
