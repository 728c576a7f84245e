"""Chain-parallel scale-out over a device mesh.

The reference is a single-address-space C library whose only concurrency
is a pthread mutex around table growth (lib/stable.c:572-575); it has no
DP/TP/PP or communication backend (SURVEY.md §2.3).  This engine's
scaling story is therefore *many-chain* data parallelism:

* the chain axis of every sampler state shards over a 1-D ``Mesh``
  ("chains"); Stirling tables (AGridTable / StirlingTable) replicate --
  they are read-only shared caches, exactly the role the reference's
  mutex-guarded shared table plays for threads;
* per-device work is embarrassingly parallel; the only collectives are
  cross-chain reductions for adaptation statistics and convergence
  diagnostics (R-hat), which XLA lowers to ``psum`` when the sharded
  ``jit`` consumes a chain-axis mean (NCCL on GPUs; the cards of a host
  are joined all to all by NVLink, so the mesh has no torus shape);
* multi-host: the same program runs under ``jax.distributed`` with the
  global chain axis spanning all hosts (process-local shards are created
  with ``jax.make_array_from_process_local_data``).

Nothing here special-cases device count -- the 8-device virtual CPU mesh
used by the tests and the driver's ``dryrun_multichip`` exercises the same
code path as a multi-GPU host.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "chain_mesh",
    "chain_sharding",
    "replicated",
    "shard_chain_tree",
    "shard_chain_tree_global",
    "rhat",
    "ess",
    "cross_chain_moments",
]

CHAIN_AXIS = "chains"


def chain_mesh(n_devices: Optional[int] = None,
               devices: Optional[list] = None) -> Mesh:
    """1-D mesh over the chain axis (all addressable devices by default)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (CHAIN_AXIS,))


def chain_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding that splits the leading (chain) axis across the mesh."""
    return NamedSharding(mesh, P(CHAIN_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully replicated sharding (tables, configs)."""
    return NamedSharding(mesh, P())


def shard_chain_tree(tree: Any, mesh: Mesh, chains: int) -> Any:
    """device_put a pytree: arrays whose leading dim == chains shard over
    the chain axis, everything else replicates.  ``chains`` must divide by
    the mesh size (pad chains up at the call site if needed)."""
    cs = chain_sharding(mesh)
    rep = replicated(mesh)

    def place(x):
        x = jnp.asarray(x) if not isinstance(x, jax.Array) else x
        if x.ndim >= 1 and x.shape[0] == chains:
            return jax.device_put(x, cs)
        return jax.device_put(x, rep)

    return jax.tree_util.tree_map(place, tree)


def shard_chain_tree_global(tree: Any, mesh: Mesh,
                            global_chains: int) -> Any:
    """Multi-process ``shard_chain_tree``: each process passes its OWN
    slice of the ensemble (leading dim == global_chains / process_count);
    those leaves assemble into global chain-sharded ``jax.Array``s via
    ``make_array_from_process_local_data``, every other leaf replicates
    (callers must pass identical values on every process -- tables and
    data are deterministic functions of the config, so they are).

    PRNG keys cannot ride this helper (no numpy form); split keys from a
    shared seed inside the jitted step instead.  Single-process calls
    defer to ``shard_chain_tree`` so drivers can be process-count
    agnostic (SURVEY.md §5.8 multi-host).
    """
    if jax.process_count() == 1:
        return shard_chain_tree(tree, mesh, global_chains)
    cs = chain_sharding(mesh)
    rep = replicated(mesh)
    local = global_chains // jax.process_count()

    def place(x):
        x = np.asarray(x)
        if x.ndim >= 1 and x.shape[0] == local:
            return jax.make_array_from_process_local_data(
                cs, x, (global_chains,) + x.shape[1:])
        return jax.make_array_from_callback(x.shape, rep,
                                            lambda idx, x=x: x[idx])

    return jax.tree_util.tree_map(place, tree)


# ---------------------------------------------------------------------------
# Convergence diagnostics: the cross-chain collectives of the design
# (SURVEY.md §5.8(a)).  Under a chain-sharded jit these reductions lower
# to psum/all-reduce across devices.
# ---------------------------------------------------------------------------

def cross_chain_moments(x, axis: int = 0):
    """(mean, var) over the chain axis -- the adaptation statistic.

    Inside a sharded jit the means become a single all-reduce; callers use
    these e.g. to pool slice-interval widths across chains.
    """
    mean = jnp.mean(x, axis=axis)
    var = jnp.var(x, axis=axis)
    return mean, var


def rhat(draws):
    """Split-R-hat (Gelman et al. 2013) over draws of shape (T, C).

    T = kept iterations, C = chains; each chain is split in half, so the
    effective chain count is 2C.  Returns a scalar; values near 1 indicate
    convergence.  This is the diagnostic the reference never had
    (SURVEY.md §4 'Implication').
    """
    draws = jnp.asarray(draws)
    T, C = draws.shape
    half = T // 2
    x = jnp.concatenate([draws[:half], draws[half:2 * half]], axis=1)  # (half, 2C)
    n = half
    chain_mean = jnp.mean(x, axis=0)
    chain_var = jnp.var(x, axis=0, ddof=1)
    B = n * jnp.var(chain_mean, ddof=1)
    W = jnp.mean(chain_var)
    var_plus = (n - 1) / n * W + B / n
    return jnp.sqrt(var_plus / W)


def ess(draws):
    """Bulk effective sample size via Geyer initial-monotone pairs,
    computed per chain then combined (draws: (T, C))."""
    draws = jnp.asarray(draws)
    T, C = draws.shape
    x = draws - jnp.mean(draws, axis=0, keepdims=True)
    # autocovariance via FFT (real, per chain)
    nfft = int(2 ** np.ceil(np.log2(2 * T)))
    f = jnp.fft.rfft(x, n=nfft, axis=0)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=nfft, axis=0)[:T].real / T
    rho = jnp.mean(acov, axis=1) / jnp.mean(acov[0])
    # Geyer: sum consecutive pairs while positive
    npair = (T - 1) // 2
    pair = rho[1:1 + 2 * npair:2] + rho[2:2 + 2 * npair:2]
    pos = jnp.cumprod(pair > 0)
    tau = 1.0 + 2.0 * (rho[0] - 1.0) + 2.0 * jnp.sum(pair * pos)
    return T * C / jnp.maximum(tau, 1.0 / (T * C))
