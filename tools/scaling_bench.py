#!/usr/bin/env python
"""Multi-device weak-scaling measurement of the chain-sharded Gibbs step.

Runs the full (sweep + sample_b + sample_a) step of __graft_entry__ on a
1-device and an N-device mesh with chains proportional to devices (weak
scaling), measures steps/s and chain-updates/s, and prints one JSON line.
The step includes a cross-chain moment reduction
(parallel.mesh.cross_chain_moments) so the chain-axis all-reduce of
SURVEY.md §5.8(a) is part of the measured program, not just the
embarrassingly parallel body.

On virtual CPU devices (``--cpu N``) the mesh oversubscribes the host's
cores, so per-device throughput cannot stay flat; the signal there is
that the sharded program compiles and runs, and that total throughput
does not collapse as the mesh grows.  On several GPUs the same script
reports the real weak scaling.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python tools/scaling_bench.py [--devices 8] [--iters 30]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def measure(n_devices: int, iters: int, chains_per_dev: int):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import __graft_entry__ as ge
    from libstb_jax.parallel import mesh as pmesh

    devices = jax.devices()[:n_devices]
    mesh = Mesh(np.asarray(devices), ("chains",))
    chains = chains_per_dev * n_devices
    step, (key, t, T, a, b, ns_flat) = ge._build(
        chains=chains, n_max=256, m_max=64, g=16, dim=16, n_per_group=100)

    cs = NamedSharding(mesh, P("chains"))
    rep = NamedSharding(mesh, P())

    def step_with_stats(key, t, T, a, b, ns_flat):
        t, T, a, b = step(key, t, T, a, b, ns_flat)
        # the cross-chain adaptation statistic (one all-reduce across devices)
        a_mean, a_var = pmesh.cross_chain_moments(a)
        b_mean, b_var = pmesh.cross_chain_moments(b)
        return t, T, a, b, jnp.stack([a_mean, a_var, b_mean, b_var])

    jstep = jax.jit(step_with_stats,
                    in_shardings=(rep, cs, cs, cs, cs, cs),
                    out_shardings=(cs, cs, cs, cs, rep))
    key = jax.device_put(key, rep)
    t = jax.device_put(t, cs)
    T = jax.device_put(T, cs)
    a = jax.device_put(a, cs)
    b = jax.device_put(b, cs)
    ns_flat = jax.device_put(ns_flat, cs)

    with mesh:
        out = jstep(key, t, T, a, b, ns_flat)   # compile + warm
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            t, T, a, b, stats = jstep(key, t, T, a, b, ns_flat)
        jax.block_until_ready((t, T, a, b, stats))
        dt = (time.perf_counter() - t0) / iters
    assert np.isfinite(np.asarray(stats)).all()
    return dict(devices=n_devices, chains=chains, sec_per_step=dt,
                chain_steps_per_s=chains / dt,
                per_device_chain_steps_per_s=chains / dt / n_devices)


def measure_ngg(n_devices: int, iters: int, chains_per_dev: int):
    """Weak scaling of the NGG saddle-point workload (BASELINE config 5):
    chain-sharded (N, K) states evaluating umax/gmax with a cross-chain
    agreement reduction."""
    import jax
    jax.config.update("jax_enable_x64", True)   # the maximizers are f64
    import jax.numpy as jnp                     # code (reference trio is
    import numpy as np                          # CPU long-double)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from libstb_jax.core import ngg

    devices = jax.devices()[:n_devices]
    mesh = Mesh(np.asarray(devices), ("chains",))
    chains = chains_per_dev * n_devices
    rng = np.random.default_rng(0)
    Ns = jnp.asarray(rng.integers(50, 100000, chains).astype(np.float64))
    Ks = jnp.asarray(np.maximum(
        1, Ns * rng.uniform(0.005, 0.05, chains)).astype(np.float64))
    cs = NamedSharding(mesh, P("chains"))
    rep = NamedSharding(mesh, P())

    def ev(N, K):
        u = ngg.umax_log(0.1, 10.0, N, K)
        g = ngg.gmax_log(0.1, 10.0, N, K)
        return u, jnp.max(jnp.abs(u - g) / jnp.maximum(jnp.abs(u), 1.0))

    jev = jax.jit(ev, in_shardings=(cs, cs), out_shardings=(cs, rep))
    Ns = jax.device_put(Ns, cs)
    Ks = jax.device_put(Ks, cs)
    u, worst = jev(Ns, Ks)
    jax.block_until_ready(u)
    t0 = time.perf_counter()
    for _ in range(iters):
        u, worst = jev(Ns, Ks)
    jax.block_until_ready(u)
    dt = (time.perf_counter() - t0) / iters
    # gross-structure sanity only (rigorous accuracy: tests/test_ngg.py);
    # small-N/large-K corners carry O(1/N) Gaussian error
    assert float(worst) < 0.2
    return dict(devices=n_devices, chains=chains, sec_per_step=dt,
                chain_steps_per_s=chains / dt,
                per_device_chain_steps_per_s=chains / dt / n_devices)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, default=0,
                   help="mesh size for the scaled run (0 = all)")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--ngg", action="store_true",
                   help="measure the NGG saddle-point workload "
                        "(BASELINE config 5) instead of the Gibbs step")
    p.add_argument("--chains-per-dev", type=int, default=128)
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="force an N-device virtual CPU mesh")
    args = p.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu}")
        import jax
        jax.config.update("jax_platforms", "cpu")
        args.devices = args.devices or args.cpu
    import jax
    from libstb_jax.utils import compile_cache
    compile_cache.enable()
    n = args.devices or len(jax.devices())
    meas = measure_ngg if args.ngg else measure
    r1 = meas(1, args.iters, args.chains_per_dev)
    rn = meas(n, args.iters, args.chains_per_dev)
    eff = rn["chain_steps_per_s"] / (r1["chain_steps_per_s"] * n)
    d = jax.devices()[0]
    result = dict(platform=d.platform, device_kind=d.device_kind,
                  r1=r1, rn=rn, weak_scaling_efficiency=round(eff, 4))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
