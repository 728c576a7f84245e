#!/usr/bin/env python
"""lgamma/digamma-difference micro-benchmark (sec/call).

The reference ships a scalar sec/call comparison of its gammadiff/psidiff
variants against raw lgamma/digamma differences under ``#ifdef MAINTEST``
(lib/lgamma.c:242-310, 5e6 reps).  This is the vectorised
analog: each variant is evaluated on a (BATCH,) vector of (n, alpha)
pairs, K times chained inside one jit (each rep feeds the previous
result's low bits back into alpha so the chain cannot be collapsed), and
the table reports seconds per ELEMENT evaluation -- the comparable unit,
since on the device one "call" is an element of a vector op, not a libm
call.

Variants (reference counterparts in lib/lgamma.c):
  gammadiff   fused lgamma-diff w/ exact small-n products (lgamma.c:143-190)
  lgamma-raw  plain lgamma(n+alpha) - lgamma(alpha)
  psidiff     fused digamma-diff w/ exact small-n sums (lgamma.c:194-240)
  digamma-raw plain digamma(n+alpha) - digamma(alpha)
  qval        S^{n+1}_2/S^{n+1}_1 closed form (qcache/qval, lgamma.c:78-114)
  gcache-gather  precomputed gcache_table + gather (lgamma.c:30-52 analog:
                 build once, amortised over GATHERS_PER_BUILD gathers)

Usage:  python tools/lgcache_bench.py [--batch 1048576] [--reps 32]
Writes a markdown-ish table to stdout; every timing waits for the device
(metrics.device_timer).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=1 << 20)
    p.add_argument("--reps", type=int, default=32)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from libstb_jax.core import lgcache
    from libstb_jax.utils import compile_cache, metrics

    compile_cache.enable()

    B, K = args.batch, args.reps
    rng = np.random.default_rng(0)
    alpha = jnp.asarray(rng.uniform(0.1, 1.0, B), jnp.float32)
    nvec = jnp.asarray(rng.integers(1, 200, B), jnp.int32)

    def chained(fn):
        @jax.jit
        def run(alpha):
            def body(c, _):
                out = fn(nvec, alpha + c * 1e-12)
                return jnp.max(out) * 1e-20, None
            c, _ = jax.lax.scan(body, jnp.float32(0), None, length=K)
            return c
        return run

    variants = {
        "gammadiff": lambda n, al: lgcache.gammadiff(n, al),
        "lgamma-raw": lambda n, al: (jax.lax.lgamma(n.astype(al.dtype) + al)
                                     - jax.lax.lgamma(al)),
        "psidiff": lambda n, al: lgcache.psidiff(n, al),
        "digamma-raw": _digamma_raw,
        "qval": lambda n, al: lgcache.qval(al * 0.9, n),
    }

    d = jax.devices()[0]
    print(f"# lgcache micro-bench: device={d.platform} {d.device_kind}, "
          f"batch={B}, reps={K} (lgamma.c:242-310 analog)")
    print(f"| variant | sec/call | Gcalls/s |")
    print(f"|---|---|---|")
    rows = {}
    for name, fn in variants.items():
        dt = metrics.device_timer(chained(fn), alpha) / (B * K)
        rows[name] = dt
        print(f"| {name} | {dt:.3g} | {1e-9 / dt:.2f} |")

    # gcache-gather: one table build (100 lgamma lanes, GCACHE=100
    # lgamma.h:22) amortised over G gathers of B indices
    G = 16
    jidx = jnp.asarray(rng.integers(0, 100, B), jnp.int32)

    @jax.jit
    def gather_run(alpha):
        def body(c, _):
            tab = lgcache.gcache_table(alpha[0] + c * 1e-12, 100)
            s = jnp.float32(0)
            for _ in range(G):
                s = s + tab[(jidx + s.astype(jnp.int32)) % 100].max() * 1e-20
            return s * 1e-3, None
        c, _ = jax.lax.scan(body, jnp.float32(0), None, length=K)
        return c

    dt = metrics.device_timer(gather_run, alpha) / (B * K * G)
    rows["gcache-gather"] = dt
    print(f"| gcache-gather (x{G} reuse) | {dt:.3g} | {1e-9 / dt:.2f} |")
    sys.stdout.flush()


def _digamma_raw(n, al):
    from libstb_jax.core import special
    return special.digamma(n.astype(al.dtype) + al) - special.digamma(al)


if __name__ == "__main__":
    main()
