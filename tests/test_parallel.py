"""Mesh sharding, R-hat/ESS diagnostics, and the multichip dry run on the
8-device virtual CPU mesh (the reference has no distributed layer --
SURVEY.md §2.3 -- so these tests cover this engine's scaling design)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from libstb_jax.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chain_mesh_all_devices():
    m = pmesh.chain_mesh()
    assert m.shape["chains"] == len(jax.devices())


def test_shard_chain_tree():
    m = pmesh.chain_mesh()
    n = m.shape["chains"]
    chains = 4 * n
    tree = {"x": jnp.zeros((chains, 3)), "table": jnp.ones((7, 5))}
    out = pmesh.shard_chain_tree(tree, m, chains)
    assert not out["x"].sharding.is_fully_replicated
    assert out["table"].sharding.is_fully_replicated


def test_rhat_converged_vs_not():
    rng = np.random.default_rng(0)
    good = rng.normal(size=(512, 8))
    r_good = float(pmesh.rhat(jnp.asarray(good)))
    assert abs(r_good - 1.0) < 0.05
    # chains at different levels -> large R-hat
    bad = good + np.arange(8)[None, :] * 5.0
    r_bad = float(pmesh.rhat(jnp.asarray(bad)))
    assert r_bad > 2.0


def test_ess_iid_vs_correlated():
    rng = np.random.default_rng(1)
    iid = rng.normal(size=(1024, 4))
    e_iid = float(pmesh.ess(jnp.asarray(iid)))
    assert e_iid > 0.5 * iid.size
    # AR(1) with rho=0.95 -> ESS much smaller
    T, C = 1024, 4
    x = np.zeros((T, C))
    for t in range(1, T):
        x[t] = 0.95 * x[t - 1] + rng.normal(size=C)
    e_ar = float(pmesh.ess(jnp.asarray(x)))
    assert e_ar < 0.15 * x.size


def test_dryrun_multichip_virtual():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as ge
        ge.dryrun_multichip(len(jax.devices()))
    finally:
        sys.path.pop(0)


def test_entry_compiles():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as ge
        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
        assert out[0].shape[0] == 16
    finally:
        sys.path.pop(0)
