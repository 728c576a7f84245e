"""Test harness config: force an 8-device virtual CPU mesh and x64 so
f64 oracles are available.  The device path (f32) is tested explicitly by
passing dtype=float32 into the functions under test; the GPU itself is
exercised by chip_smoke.py.
"""
import os

# force CPU: the unit suite runs on the 8-device virtual CPU mesh even on
# a machine with a GPU
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import gc

import jax
import pytest

# jax may already have been imported with another platform; override the
# live config, not just the env var.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches_between_modules():
    """Release compiled executables after every test module.

    The full suite compiles thousands of jit programs whose executables
    (with table pytrees baked in as constants) stay live in jax's global
    caches; on glibc each >128k constant buffer is its own mmap, and the
    process crosses vm.max_map_count (65530) around test #113 -- at which
    point the next LLVM compile segfaults or deadlocks (measured:
    maps=65521 right before the crash, ~700 after a clear).  Modules
    don't share jitted closures, so clearing between modules costs
    nothing but the conftest-level recompiles.
    """
    yield
    jax.clear_caches()
    gc.collect()
