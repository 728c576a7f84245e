#!/usr/bin/env python
"""Long-compile on-device measurements kept out of bench.py.

Each measurement here adds its own XLA compile, so bench.py keeps its
one-JSON-line contract and this tool produces the extra rows:

  make     production stirling.make() wall-clock at (2^20, 1024) -- the
           user-visible single-table path: the fill + host f64 S1
           (overlapped with the fill via async dispatch) + transfers
  ensure   N-growth ensure(2^19 -> 2^20) (resume from the frontier row)
           vs a fresh make at 2^20
  sparse   sample_a over 2^20+17 occupied CSR pairs (the getval-scale
           workload, psample.h:101-115): samples/s on device
  hsa      hsa_sweep item-updates/s at a moderate scale + the scope
           note (HSA is the small-scale oracle; CTW/TI are the scale
           kernels)
  hsapairs staged pair-major HSA at check.c scale
  ctw      ctw_sweep_rel at check.c scale with and without the
           gather-free Srel path (pyp.ctw_m_sel)

Every timing waits for the device (metrics.device_timer, best of 3).
Usage: python tools/extra_bench.py [--only make,ensure,...]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def bench_make_and_ensure(which):
    from libstb_jax.core import stirling

    N, M = 1 << 20, 1024

    def one_make(a, n):
        t0 = time.perf_counter()
        tab = stirling.make(n, M, 1 << 21, 2048, a, use_asympt=True)
        jax.block_until_ready(tab)
        return time.perf_counter() - t0, tab

    if "make" in which:
        one_make(0.31, N)                        # compile warmup
        dt = min(one_make(a, N)[0] for a in (0.45, 0.5, 0.55))
        print(f"make(2^20,1024) production wall: {dt*1e3:.1f} ms "
              f"({N*M*8/dt/1e9:.0f} GB/s incl. host S1 + transfers)",
              flush=True)
    if "ensure" in which:
        _, small = one_make(0.52, 1 << 19)       # 4.3 GB; keep at most
        t0 = time.perf_counter()                 # two tables alive
        grown = stirling.ensure(small, (1 << 20) - 2, M - 2)
        jax.block_until_ready(grown)
        dt_g = time.perf_counter() - t0
        assert grown.n_max == 1 << 20, grown.n_max
        del small, grown
        dt_f = one_make(0.52, N)[0]
        print(f"ensure(2^19 -> 2^20): {dt_g*1e3:.1f} ms (resume route) vs "
              f"fresh make {dt_f*1e3:.1f} ms", flush=True)


def bench_sparse():
    from libstb_jax.core import agrid
    from libstb_jax.samplers import hyper
    from libstb_jax.utils import metrics

    grid = agrid.make_grid(96, 32, g=16)
    rng = np.random.default_rng(4)
    C, P = 4, (1 << 20) + 17
    ns = jnp.asarray(rng.integers(2, 90, P).astype(np.int32))
    ts = jnp.asarray(np.minimum(
        rng.integers(1, 30, (C, P)).astype(np.int32), np.asarray(ns)[None]))
    T = jnp.asarray(np.asarray(ts).sum(axis=1, dtype=np.float32)
                    .reshape(C, 1))
    b = jnp.asarray([[10.0]] * C)
    iters = 8

    @jax.jit
    def run(key, a0):
        def step(carry, _):
            a, key = carry
            key, k = jax.random.split(key)
            a, ok = hyper.sample_a(k, a, grid, ns, ts, T, b)
            return (a, key), None
        (a, _), _ = jax.lax.scan(step, (a0, key), None, length=iters)
        return a

    dt = metrics.device_timer(run, jax.random.key(0), jnp.full((C,), 0.5))
    print(f"sparse sample_a (CSR, {P} pairs, C={C}): {C*iters/dt:.3g} "
          f"samples/s = {C*iters*P/dt:.3g} pair-terms/s", flush=True)


def _sweeps_timed(sweep, state0, sweeps):
    """Seconds for ``sweeps`` chained sweeps of ``sweep(key, *state)``."""
    from libstb_jax.utils import metrics

    @jax.jit
    def run(key, state):
        def body(carry, _):
            state, key = carry
            key, k = jax.random.split(key)
            return (sweep(k, *state), key), None
        (state, _), _ = jax.lax.scan(body, (state, key), None,
                                     length=sweeps)
        return state

    return metrics.device_timer(run, jax.random.key(0), state0)


def bench_hsa():
    from libstb_jax.models import pyp

    data = pyp.crp_generate(seed=2, n_groups=6, dim=20, n_per_group=400,
                            a=0.5, b=10.0)
    L = data.data_cat.size
    C = 32
    a = jnp.full((C,), 0.5, jnp.float32)
    b = jnp.full((C,), 10.0, jnp.float32)
    sweeps = 2
    dt = _sweeps_timed(lambda k, hist, T: pyp.hsa_sweep(k, hist, T, a, b,
                                                        data),
                       pyp.init_hsa(data, C), sweeps)
    print(f"HSA (item-sequential oracle, N={L}, C={C}): "
          f"{C*L*sweeps/dt:.3g} item-updates/s -- small-scale oracle only; "
          f"TI/CTW are the scale kernels", flush=True)


def bench_hsa_pairs():
    """Staged pair-major HSA at check.c scale (N = 10^5): the histogram
    sampler's scale route (dense size-axis algebra, no gathers)."""
    from libstb_jax import native
    from libstb_jax.models import pyp

    data = native.crp_generate(1, 100, 20, 1000, 0.5, 10.0)
    L = data.data_cat.size
    C = 32
    a = jnp.full((C,), 0.5, jnp.float32)
    b = jnp.full((C,), 10.0, jnp.float32)
    jvec, ivec, nvec = pyp.ti_pair_layout(data)
    order, stages = pyp.ti_pair_stages(nvec, skip_first=False)
    hp0, T0 = pyp.init_hsa_pairs(data, C, order=order)
    jv = jnp.asarray(jvec[order])
    iv = jnp.asarray(ivec[order])
    nv = jnp.asarray(nvec[order])
    s_max = hp0.shape[-1] - 1
    sweeps = 2
    dt = _sweeps_timed(
        lambda k, hp, T: pyp.hsa_sweep_pairs_staged(
            k, hp, T, a, b, data, jv, iv, nv, stages, s_max),
        (hp0, T0), sweeps)
    print(f"HSA pair-major staged (N={L}, C={C}, s_max={s_max}): "
          f"{C*L*sweeps/dt:.3g} item-updates/s ({dt/sweeps*1e3:.1f} "
          f"ms/sweep)", flush=True)


def bench_ctw():
    from libstb_jax import native
    from libstb_jax.core import stirling
    from libstb_jax.models import pyp

    data = native.crp_generate(1, 100, 20, 1000, 0.5, 10.0)
    L = data.data_cat.size
    n_max = int(data.n.max()) + 2
    tab = stirling.make(n_max, min(n_max, 1024), n_max + 64,
                        min(n_max, 1024) + 64, 0.5, use_asympt=True)
    C = 32
    a = jnp.full((C,), 0.5, jnp.float32)
    b = jnp.full((C,), 10.0, jnp.float32)
    sweeps = 4
    for m_sel in (0, pyp.ctw_m_sel(tab, data, window=10)):
        dt = _sweeps_timed(
            lambda k, t, T, m_sel=m_sel: pyp.ctw_sweep_rel(
                k, t, T, a, b, tab, data, window=10, m_sel=m_sel),
            pyp.init_state(data, C), sweeps)
        print(f"CTW(rel,w=10) N={L} C={C} m_sel={m_sel}: "
              f"{C*L*sweeps/dt:.3g} item-updates/s", flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--only", type=str,
                   default="make,ensure,sparse,hsa,hsapairs,ctw")
    args = p.parse_args()
    which = set(args.only.split(","))
    from libstb_jax.utils import compile_cache
    compile_cache.enable()
    d = jax.devices()[0]
    print(f"# extra_bench device={d.platform} {d.device_kind} "
          f"x{len(jax.devices())}", flush=True)
    if which & {"make", "ensure"}:
        bench_make_and_ensure(which)
    if "sparse" in which:
        bench_sparse()
    if "hsa" in which:
        bench_hsa()
    if "hsapairs" in which:
        bench_hsa_pairs()
    if "ctw" in which:
        bench_ctw()


if __name__ == "__main__":
    main()
