"""utils: checkpoint round-trip, metrics, config, yaps facade."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libstb_jax.utils import checkpoint, config, metrics, yaps


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "t": jnp.arange(12).reshape(3, 4),
        "a": jnp.asarray([0.5, 0.6]),
        "key": jax.random.key(7),
    }
    p = checkpoint.save(str(tmp_path / "ck"), state, meta={"iter": 42})
    assert os.path.exists(p)
    loaded, meta = checkpoint.load(p, like=state)
    assert meta["iter"] == 42
    np.testing.assert_array_equal(np.asarray(loaded["t"]),
                                  np.asarray(state["t"]))
    # key round-trips: same draws
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(loaded["key"], (3,))),
        np.asarray(jax.random.uniform(state["key"], (3,))))


def test_checkpoint_load_without_like(tmp_path):
    # structure restored from the serialised treedef sidecar
    state = {"t": jnp.arange(6).reshape(2, 3), "cfg": (1.5, 2.5),
             "key": jax.random.key(3)}
    p = checkpoint.save(str(tmp_path / "ck2"), state, meta={"n": 1})
    loaded, meta = checkpoint.load(p)
    assert isinstance(loaded, dict) and set(loaded) == set(state)
    np.testing.assert_array_equal(np.asarray(loaded["t"]),
                                  np.asarray(state["t"]))
    assert tuple(np.asarray(x) for x in loaded["cfg"]) == (1.5, 2.5)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(loaded["key"], (2,))),
        np.asarray(jax.random.uniform(state["key"], (2,))))


def test_meter():
    m = metrics.Meter("fill", "cells/s")
    m.add(1000, 0.5)
    m.add(1000, 0.5)
    assert m.rate == 2000
    assert "fill" in m.report()


def test_device_timer_runs():
    f = jax.jit(lambda x: x * 2.0)
    dt = metrics.device_timer(f, jnp.ones((64, 64)), reps=2)
    assert dt > 0


def test_config_env_overrides(monkeypatch):
    monkeypatch.setenv("LIBSTB_GRID_POINTS", "32")
    monkeypatch.setenv("LIBSTB_USE_ASYMPT", "false")
    c = config.from_env(config.TableConfig)
    assert c.grid_points == 32 and c.use_asympt is False
    s = config.from_env(config.SamplerConfig)
    assert s.kernel == "slice"


def test_yaps_sink_and_quit():
    got = []
    yaps.set_sink(got.append)
    try:
        yaps.message("hello %d", 7)
        with pytest.raises(yaps.LibstbError):
            yaps.quit("fatal %s", "x")
    finally:
        yaps.set_sink(None)
    assert got == ["hello 7", "fatal x"]


def test_device_timer_waits_for_outputs():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x + 1.0, "z": (x * 2.0,)}

    dt = metrics.device_timer(fn, jnp.ones((8,)), reps=3)
    assert dt > 0 and len(calls) == 4          # warm call + 3 timed


def test_compile_cache_env_dir_is_jax_own(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper sets no other directory."""
    from libstb_jax.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_in_checkout(monkeypatch):
    from libstb_jax.utils import compile_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable()
        assert got == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_lands_in_env_dir(tmp_path):
    """A script that calls enable() with the variable set writes its
    compiled programs there."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import jax, jax.numpy as jnp; "
            "from libstb_jax.utils import compile_cache; "
            "compile_cache.enable(); "
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0); "
            "jax.block_until_ready(jax.jit(lambda x: x * 3.0 + 1.0)"
            "(jnp.ones(4)))")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                   check=True, timeout=300)
    assert os.listdir(tmp_path)


def test_distributed_init_without_coordinator(monkeypatch):
    from libstb_jax.parallel import distributed

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert distributed.init() is False
    assert not distributed.is_distributed()
