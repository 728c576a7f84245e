"""Persistent XLA compilation cache for the entry-point scripts.

The Gibbs programs are scan-heavy and take long to compile, so the
scripts (``chip_smoke.py``, ``bench.py``, ``cli/*.py``, ``tools/*.py``)
call ``enable()`` before their first compile.  Importing the package and
running the tests does not.
"""
from __future__ import annotations

import os

import jax

__all__ = ["REPO_CACHE_DIR", "enable"]

# a fixed path inside the checkout: the path is part of the cache key, so
# a directory that moved from run to run would never hit
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable() -> str:
    """Turn on the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it as its
    own setting and nothing else is set here; otherwise the cache goes to
    ``<repo>/.jax_cache/``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
