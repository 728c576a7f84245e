"""Multi-host initialization helpers.

The reference is single-process (SURVEY.md §2.3); multi-host scale-out is
this framework's addition.  One call per process:

    from libstb_jax.parallel import distributed
    distributed.init("host0:1234", num_processes=2, process_id=0)
    mesh = mesh.chain_mesh()              # global devices

then shard chain state with ``parallel.mesh.shard_chain_tree`` -- on
multi-host, build global arrays from process-local shards with
``host_local_chains``.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

__all__ = ["init", "is_distributed", "host_local_chains"]

_initialized = False


def init(coordinator: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed (idempotent).

    Runs only when a coordinator is given, as ``coordinator`` or through
    JAX_COORDINATOR_ADDRESS, with ``num_processes`` and ``process_id``.
    With none, this is a single-process run -- one process drives every
    card of its host -- and nothing is initialized.  Returns True if a
    multi-process runtime is active.
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return False                    # single-process run; nothing to do
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes, process_id=process_id)
        _initialized = True
    except (RuntimeError, ValueError):
        return jax.process_count() > 1
    return jax.process_count() > 1


def is_distributed() -> bool:
    return jax.process_count() > 1


def host_local_chains(global_chains: int) -> int:
    """Per-process chain count for an evenly sharded global ensemble."""
    p = jax.process_count()
    if global_chains % p:
        raise ValueError(f"{global_chains} chains not divisible by "
                         f"{p} processes")
    return global_chains // p
