#!/usr/bin/env python
"""NGG generalized-Stirling tables -- the test/ngg_test.c analog.

Builds the S table and the Lambda1 ratio table for the Normalized
Generalized Gamma process, then prints the (n, k) comparison of table
values vs the umax saddle-point approximation vs tanh-sinh quadrature
(ngg_test.c:502-533's main output, with the quadrature column that
ngg_integral.cpp provides).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", type=float, default=0.1, help="NGG discount")
    p.add_argument("-M", type=float, default=10.0, help="NGG mass")
    p.add_argument("-N", type=int, default=16, help="max n")
    p.add_argument("-K", type=int, default=10, help="max k")
    p.add_argument("--step", type=int, default=2)
    p.add_argument("--chains", type=int, default=0,
                   help="sharded posterior-workload mode: evaluate the "
                        "saddle-point family over this many (n, k) "
                        "chains sharded across the device mesh "
                        "(BASELINE config 5)")
    args = p.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    from libstb_jax.core import ngg
    from libstb_jax.utils import compile_cache

    compile_cache.enable()
    a, M, N, K = args.a, args.M, args.N, args.K
    if args.chains:
        return ngg_workload(args)
    tab = np.asarray(ngg.ngg_table(a, M, N, K))
    R = np.asarray(ngg.ngg_ratio_table(a, M, N, K))
    print(f"NGG tables: a={a} M={M} N={N} K={K}")
    print(f"{'n':>4} {'k':>3} {'T=log table':>14} {'umax':>12} "
          f"{'hmax':>12} {'hmax2':>12} {'gmax':>12} {'quadrature':>14} "
          f"{'L1 ratio':>12}")
    for n in range(1, N, args.step):
        for k in range(1, min(n, K - 1) + 1, args.step):
            t = tab[k - 1, n - 1]
            u = float(ngg.umax_log(a, M, n, k))
            h = float(ngg.hmax_log(a, M, n, k))
            h2 = float(ngg.hmax2_log(a, M, n, k))
            g = float(ngg.gmax_log(a, M, n, k))
            q = float(ngg.ngg_quadrature_log(a, M, n, k))
            r = R[k - 1, n - 1] if n < N else float("nan")
            print(f"{n:4d} {k:3d} {t:14.6f} {u:12.6f} {h:12.6f} "
                  f"{h2:12.6f} {g:12.6f} {q:14.6f} {r:12.8f}")
    print("\nlarge-n ratio table via quadrature method (n up to 200):")
    Rb = np.asarray(ngg.ngg_ratio_table(a, M, 200, K,
                                        method="quadrature"))
    for n in (50, 100, 199):
        row = " ".join(f"{Rb[k - 1, n - 1]:.6f}" for k in range(1, K, 2))
        print(f"  n={n:4d}: {row}")


def ngg_workload(args):
    """Chain-sharded NGG posterior workload (BASELINE config 5): many
    (n, k) states evaluate the saddle-point family simultaneously, the
    chain axis sharded over the device mesh (collectives only for
    the final agreement statistics).  The 10^5-chain scale of the config
    fits one jit program; multi-host runs shard the same program over
    jax.distributed (parallel/distributed.py)."""
    import time

    import jax
    import jax.numpy as jnp
    from libstb_jax.core import ngg
    from libstb_jax.parallel import mesh as pmesh

    C = args.chains
    mesh = pmesh.chain_mesh()
    nd = mesh.devices.size
    C = (C // nd) * nd or nd
    rng = np.random.default_rng(0)
    Ns = rng.integers(50, 100000, C).astype(np.float64)
    Ks = np.maximum(1, (Ns * rng.uniform(0.005, 0.05, C))).astype(np.float64)
    st = pmesh.shard_chain_tree(dict(N=jnp.asarray(Ns), K=jnp.asarray(Ks)),
                                mesh, C)

    @jax.jit
    def evaluate(N, K):
        u = ngg.umax_log(args.a, args.M, N, K)
        g = ngg.gmax_log(args.a, args.M, N, K)
        rel = jnp.abs(u - g) / jnp.maximum(jnp.abs(u), 1.0)
        return u, g, jnp.max(rel), jnp.mean(rel)   # cross-chain reduce

    u, g, worst, mean = evaluate(st["N"], st["K"])
    jax.block_until_ready(u)
    t0 = time.perf_counter()
    u, g, worst, mean = evaluate(st["N"], st["K"])
    jax.block_until_ready(u)
    dt = time.perf_counter() - t0
    print(f"NGG workload: {C} chains on {nd} device(s): "
          f"{2 * C / dt:.3g} saddle-evals/s; u-vs-g agreement "
          f"max {float(worst):.2e} mean {float(mean):.2e}")
    assert float(worst) < 0.05, "saddle representations disagree"


if __name__ == "__main__":
    main()
