"""Distributed grid fill: each device fills its discount shard
(SURVEY.md §5.8 capability), validated on the 8-device virtual mesh."""
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from libstb_jax.core import agrid


def test_sharded_grid_matches_local():
    mesh = Mesh(np.asarray(jax.devices()), ("grid",))
    gs = agrid.make_grid(40, 20, g=16, mesh=mesh)
    gl = agrid.make_grid(40, 20, g=16)
    assert not gs.vtab.sharding.is_fully_replicated
    np.testing.assert_allclose(np.asarray(gs.vtab), np.asarray(gl.vtab))
    fin = np.isfinite(np.asarray(gl.srel))
    np.testing.assert_allclose(np.asarray(gs.srel)[fin],
                               np.asarray(gl.srel)[fin])
    # queries work against the sharded table
    q = float(gs.S(jnp.asarray(30), jnp.asarray(4), jnp.asarray(0.37)))
    q0 = float(gl.S(jnp.asarray(30), jnp.asarray(4), jnp.asarray(0.37)))
    assert q == q0


def test_sharded_grid_indivisible_raises():
    mesh = Mesh(np.asarray(jax.devices()), ("grid",))
    try:
        agrid.make_grid(20, 10, g=12 + 1, mesh=mesh)
    except ValueError:
        return
    assert len(jax.devices()) == 1  # only a 1-device mesh accepts any g
