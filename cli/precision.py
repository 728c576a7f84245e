#!/usr/bin/env python
"""Precision comparison -- the test/precision_test.c analog.

Fills the same table four ways -- {f32, f64} x {log recursion, ratio
recursion} -- and prints side-by-side accuracy + timing, demonstrating
the reference's conclusion that the ratio recursion is far more accurate
in float (precision_test.c:10-13).  The log recursion is implemented
inline here exactly for this comparison (the library itself only ships
the ratio form).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", type=float, default=0.5)
    p.add_argument("-N", type=int, default=10000)
    p.add_argument("-M", type=int, default=4000, help="columns")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    from libstb_jax.core import stirling
    from libstb_jax.utils import compile_cache

    compile_cache.enable()

    N, M, a = args.N, min(args.M, args.N), args.a

    def log_fill(dtype):
        """The reference's log-space recurrence (stable.c:380-387)."""
        mvec = jnp.arange(1, M + 1, dtype=dtype)
        row0 = jnp.where(mvec == 1.0, 0.0, -jnp.inf).astype(dtype)

        @jax.jit
        def run(a):
            a = jnp.asarray(a, dtype)

            def step(row, n):
                coef = jnp.log(jnp.maximum(n - 1.0 - mvec * a, 1e-30))
                shifted = jnp.concatenate(
                    [jnp.full((1,), -jnp.inf, dtype), row[:-1]])
                new = jnp.logaddexp(shifted, coef + row)
                new = jnp.where(mvec == 1.0,
                                row[0] + jnp.log(n - 1.0 - a), new)
                return new, None

            last, _ = jax.lax.scan(step, row0,
                                   jnp.arange(2, N + 1, dtype=dtype))
            return last
        return run

    def ratio_fill(dtype):
        s1 = jnp.asarray(stirling.s1_host(a, N)[-1], dtype)

        @jax.jit
        def run(a):
            v, srel, _ = stirling.fill_rows(a, N, M, dtype=dtype)
            return srel[-1] + s1
        return run

    runs = {
        "log/f64": log_fill(jnp.float64),
        "log/f32": log_fill(jnp.float32),
        "ratio/f64": ratio_fill(jnp.float64),
        "ratio/f32": ratio_fill(jnp.float32),
    }
    rows, times = {}, {}
    for name, fn in runs.items():
        fn(a).block_until_ready()
        t0 = time.time()
        out = fn(a)
        out.block_until_ready()
        times[name] = (time.time() - t0) * 1e3
        rows[name] = np.asarray(out, np.float64)

    ref = rows["ratio/f64"]
    print(f"log S(N={N}, m; a={a}) final row, per-variant "
          f"max |err| vs ratio/f64 and time:")
    for name in runs:
        fin = np.isfinite(ref)
        err = np.max(np.abs(rows[name][fin] - ref[fin]))
        print(f"  {name:10s}: max|err| = {err:10.4g}   "
              f"fill = {times[name]:8.1f} ms")
    print("\nconclusion check (precision_test.c:10-13): "
          "ratio/f32 error should be orders of magnitude below log/f32.")


if __name__ == "__main__":
    main()
