#!/usr/bin/env python
"""Table dumper -- the test/list.c analog.

Prints S / V / U / UV values for a discount, compares exact table values
against the asymptotic expressions (list.c:91-109), and exercises
auto-extension by querying beyond initial bounds (list.c:119-127).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", type=float, default=0.5)
    p.add_argument("-N", type=int, default=100, help="initial N")
    p.add_argument("-M", type=int, default=20, help="initial M")
    p.add_argument("--maxN", type=int, default=1000)
    p.add_argument("--maxM", type=int, default=100)
    p.add_argument("--asymptote", action="store_true",
                   help="print exact-vs-asymptote differences")
    args = p.parse_args()

    from libstb_jax.core import stirling
    from libstb_jax.utils import compile_cache

    compile_cache.enable()

    t = stirling.make(args.N, args.M, args.maxN, args.maxM, args.a,
                      use_asympt=True)
    print(t.report())

    ns = [2, 5, 10, args.N // 2, args.N]
    ms = [1, 2, 3, 5, 10]
    print("\nlog S(n,m):")
    for n in ns:
        row = [f"{float(t.S(n, m)):12.5f}" for m in ms if m <= n]
        print(f"  n={n:6d}: " + " ".join(row))
    print("\nV(n,m):")
    for n in ns:
        row = [f"{float(t.V(n, m)):12.6f}" for m in ms if 2 <= m <= n]
        print(f"  n={n:6d}: " + " ".join(row))
    print("\nU(n,m):")
    for n in ns:
        row = [f"{float(t.U(n, m)):12.5f}" for m in ms if m <= n]
        print(f"  n={n:6d}: " + " ".join(row))

    if args.asymptote:
        print("\nexact vs asymptote (log S):")
        for n in ns:
            for m in ms:
                if m <= n and n > 2:
                    exact = float(t.S(n, m))
                    asym = float(stirling.s_asympt(t.a, t.lga1, n, m))
                    print(f"  S({n},{m}): exact={exact:.5f} "
                          f"asympt={asym:.5f} diff={exact-asym:+.2e}")

    # auto-extension past initial bounds (ensure = S_extend semantics)
    big_n = min(args.N * 2, args.maxN - 1)
    t2 = stirling.ensure(t, big_n, args.M)
    print(f"\nafter ensure({big_n}, {args.M}): {t2.report()}")
    print(f"  S({big_n},5) = {float(t2.S(big_n, 5)):.5f}")


if __name__ == "__main__":
    main()
