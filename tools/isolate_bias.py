#!/usr/bin/env python
"""Diagnostic: isolate which sampler (a or b) disagrees with the
reference by running the demo workload with one of them disabled.

Experiment A: -H 2 only (sample b, fix a=0.5)   -> compare E[T], E[b]
Experiment B: -I 5 only (sample a, fix b=1.0)   -> compare E[T], E[a]
Experiment C: neither (fixed a=0.5, b=1.0)      -> compare E[T] (sweep only)
"""
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from oracle_compare import build_reference, compare


def run_ref(demo, seed, iters, n_per, extra):
    res = subprocess.run(
        [demo, "-s", str(seed), "-C", str(iters), "-N", str(n_per),
         "-a", "0.5"] + extra,
        capture_output=True, text=True, timeout=600, check=True)
    out = res.stdout + "\n" + res.stderr
    n = {}
    for m in re.finditer(r"n\[(\d+)\] =([ \d]+)= \d+", out):
        n[int(m.group(1))] = [int(x) for x in m.group(2).split()]
    T = {int(m.group(1)): float(m.group(2))
         for m in re.finditer(r"T\[(\d+)\]=([\d.]+)", out)}
    ma = re.search(r"^a=([\d.]+)", out, re.M)
    mb = re.search(r"^b=([\d.]+)", out, re.M)
    J = max(n) + 1
    return (np.asarray([n[j] for j in range(J)], np.int32),
            np.asarray([T[j] for j in range(J)]),
            float(ma.group(1)) if ma else np.nan,
            float(mb.group(1)) if mb else np.nan)


def main():
    seed, iters, n_per, runs, chains = 7, 800, 40, 8, 96
    demo = build_reference()

    from libstb_jax.core import agrid
    from libstb_jax.models import driver, pyp
    from libstb_jax.utils import compile_cache

    compile_cache.enable()

    for name, extra, bcyc, acyc in [
            ("C sweep-only", [], 0, 0),
            ("A b-only", ["-H", "2"], 2, 0),
            ("B a-only", ["-I", "5"], 0, 5)]:
        ref_T, ref_a, ref_b = [], [], []
        nmat = None
        for r in range(runs):
            n, T, a, b = run_ref(demo, seed, iters, n_per, extra)
            nmat = n if nmat is None else nmat
            ref_T.append(T); ref_a.append(a); ref_b.append(b)
        ref_T = np.asarray(ref_T)
        data = pyp.from_counts(nmat)
        n_max = max(int(data.N.max()) + 2, 16)
        grid = agrid.make_grid(n_max, n_max, g=96, dtype=jnp.float64)
        cfg = driver.GibbsConfig(iters=iters, bcycle=bcyc, acycle=acyc,
                                 sampler="TI", scale=float(nmat.shape[1]),
                                 ti_legacy=True, ti_skip_first=False)
        out = driver.run_gibbs(jax.random.key(seed + 1), data, grid,
                               chains, 0.5, 1.0, cfg)
        print(f"== experiment {name} ==")
        compare("E[T_j]", ref_T, np.asarray(out["Tave"]), floor=0.05)
        if bcyc:
            compare("E[b]  ", np.asarray(ref_b)[:, None],
                    np.asarray(out["bave"])[:, None], floor=0.05)
        if acyc:
            compare("E[a]  ", np.asarray(ref_a)[:, None],
                    np.asarray(out["aave"])[:, None], floor=0.01)


if __name__ == "__main__":
    main()
