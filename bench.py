"""Headline benchmark: Stirling discount-grid table fill vs a copy roofline.

Prints ONE JSON line on stdout:
  {"metric": "stirling_grid_fill", "value": <GB/s>, "unit": "GB/s",
   "vs_baseline": <achieved / (0.8 * measured copy roofline)>}

The baseline is the north star of BASELINE.json: fill log S(n,m;a) tables
at >80% of the memory-bandwidth roofline.  The roofline is *measured* on
the same card with a chained streaming copy (the reference publishes no
numbers -- BASELINE.md row 1), so vs_baseline >= 1 means the target is
met on this hardware.

Secondary numbers (the single table at n = 2^20, sampler throughput, the
>=1e5 (a,b) samples/s target) and the card's name and power limit go to
stderr so the single-line contract holds.  The benchmark runs on a GPU
only; every timing ends in ``jax.block_until_ready``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp


def _timed_med(run, reps: int = 3) -> float:
    """Median seconds of ``reps`` calls of an already-compiled thunk,
    each waiting for the device."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def copy_roofline(k: int = 64) -> float:
    """Streaming-copy bandwidth (read+write) in bytes/s."""
    x = jnp.zeros((128, 1024, 1024), jnp.float32)   # 0.5 GB

    @jax.jit
    def chain(x):
        return jax.lax.fori_loop(0, k, lambda i, y: y * 1.0000001 + 1e-9, x)

    jax.block_until_ready(chain(x))
    dt = _timed_med(lambda: chain(x))
    return k * 2 * x.size * 4 / dt


def fill_throughput(g: int = 64, n: int = 1 << 14, m: int = 1024):
    """Grid-fill bytes/s and cells/s (V + Srel outputs) through the
    production path, agrid.make_grid (host S1 included)."""
    from libstb_jax.core import agrid

    jax.block_until_ready(agrid.make_grid(n, m, g=g))        # compile
    dt = _timed_med(lambda: agrid.make_grid(n, m, g=g))
    cells = g * n * m
    return cells * 8 / dt, cells / dt


def single_table_throughput(n: int = 1 << 20, m: int = 1024):
    """North-star: ONE table filled to n=2^20 through stirling.make
    (BASELINE.md: fill log S(n,m;a) to n=10^6 at >80% roofline).  One
    warm call compiles; one timed call at another discount follows."""
    from libstb_jax.core import stirling

    jax.block_until_ready(stirling.make(n, m, 2 * n, 2 * m, 0.5))
    t0 = time.perf_counter()
    jax.block_until_ready(stirling.make(n, m, 2 * n, 2 * m, 0.45))
    dt = time.perf_counter() - t0
    cells = n * m
    return cells * 8 / dt, cells / dt


def sweep_throughput(chains: int = 32, sweeps: int = 4):
    """Gibbs-sweep throughput at check.c scale (check.c:83 MAXDATA=1e5):
    N = 100,000 items (100 groups x 1000), DIM = 20.  Measures the
    relative-window CTW sweep (category-scan) and the staged pair-major
    TI sweep in item-updates/s (items x chains / s)."""
    from libstb_jax import native
    from libstb_jax.core import stirling
    from libstb_jax.models import pyp

    gen = native.crp_generate if native.available() else pyp.crp_generate
    data = gen(1, 100, 20, 1000, 0.5, 10.0)
    L = data.data_cat.size
    n_max = int(data.n.max()) + 2
    tab = stirling.make(n_max, min(n_max, 1024), n_max + 64,
                        min(n_max, 1024) + 64, 0.5, use_asympt=True)
    t0_, T0_ = pyp.init_state(data, chains)
    a = jnp.full((chains,), 0.5, jnp.float32)
    b = jnp.full((chains,), 10.0, jnp.float32)
    jvec, ivec, nvec = pyp.ti_pair_layout(data)
    order, stages = pyp.ti_pair_stages(nvec)
    jvec, ivec, nvec = jvec[order], ivec[order], nvec[order]
    jv, iv, nv = jnp.asarray(jvec), jnp.asarray(ivec), jnp.asarray(nvec)

    def timed(fn, state0):
        @jax.jit
        def run(key, st):
            def body(carry, _):
                st, key = carry
                key, k = jax.random.split(key)
                return (fn(k, st), key), None
            (st, _), _ = jax.lax.scan(body, (st, key), None, length=sweeps)
            return st
        key = jax.random.key(0)
        jax.block_until_ready(run(key, state0))
        return chains * L * sweeps / _timed_med(lambda: run(key, state0))

    ctw_msel = pyp.ctw_m_sel(tab, data, window=10)
    ctw = timed(lambda k, st: pyp.ctw_sweep_rel(
        k, st[0], st[1], a, b, tab, data, window=10, m_sel=ctw_msel),
        (t0_, T0_))
    # pair-major TI, count-staged schedule: state stays pair-major (in
    # descending-count order) across sweeps; the conversion is once per
    # run in production (models/pyp.ti_sweep_pairs).  m_sel enables the
    # gather-free V row-selection path (pyp.ti_pair_m_sel).
    tp0 = t0_[:, jv, iv]
    m_sel = pyp.ti_pair_m_sel(tab, nvec)
    ti = timed(lambda k, st: pyp.ti_sweep_pairs_staged(
        k, st[0], st[1], a, b, tab, data, jv, iv, nv, stages,
        m_sel=m_sel), (tp0, T0_))
    return L, ctw, ti


def ab_sampling(chains: int = 4096, iters: int = 32):
    """Joint (a,b) posterior sampling on the demo workload: returns
    ``(run, args)`` where ``run(*args)`` is jitted and gives the chains'
    (a, b) after ``iters`` steps."""
    from libstb_jax.core import agrid
    from libstb_jax.models import pyp
    from libstb_jax.samplers import hyper

    data = pyp.crp_generate(seed=0, n_groups=4, dim=20, n_per_group=100,
                            a=0.5, b=10.0)
    grid = agrid.make_grid(512, 128, g=64)
    dt = jnp.float32
    ns_flat = jnp.asarray(data.n.reshape(-1))
    N_b = jnp.asarray(data.N, dt)
    t0_, T0_ = pyp.init_state(data, chains)

    @jax.jit
    def run(key, t, T):
        a = jnp.full((chains,), 0.5, dt)
        b = jnp.full((chains,), 10.0, dt)

        def step(carry, _):
            a, b, key = carry
            key, kb, ka = jax.random.split(key, 3)
            b, _ = hyper.sample_b(kb, b, N_b, T.astype(dt), a,
                                  shape=1.1, scale=20.0)
            a, _ = hyper.sample_a(ka, a, grid, ns_flat,
                                  t.reshape(chains, -1), T.astype(dt),
                                  jnp.broadcast_to(b[:, None], T.shape))
            return (a.astype(dt), b.astype(dt), key), None
        (a, b, _), _ = jax.lax.scan(step, (a, b, key), None, length=iters)
        return a, b

    return run, (jax.random.key(0), t0_, T0_)


def sampler_throughput(chains: int = 4096, iters: int = 32):
    """Joint (a,b) posterior samples/s on the demo workload."""
    run, args = ab_sampling(chains, iters)
    jax.block_until_ready(run(*args))
    return chains * iters / _timed_med(lambda: run(*args), reps=1)


def _contract(value_bps: float, bw: float) -> str:
    return json.dumps({
        "metric": "stirling_grid_fill",
        "value": round(value_bps / 1e9, 1),
        "unit": "GB/s",
        "vs_baseline": round(value_bps / (0.8 * bw), 3) if bw else 0.0,
    })


def main():
    d = jax.devices()[0]
    if d.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {d.platform}",
              file=sys.stderr)
        sys.exit(1)
    from libstb_jax.utils import compile_cache
    compile_cache.enable()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"# device: {d.device_kind} x{len(jax.devices())}; card: {card}",
          file=sys.stderr)
    try:
        bw = copy_roofline()
    except Exception as e:                      # keep the contract line
        print(f"roofline bench failed: {e!r}", file=sys.stderr)
        print(_contract(0.0, 0.0))
        return
    try:
        # before the grid fill: its 8.6 GB table wants a clean heap
        one_bps, one_cps = single_table_throughput()
    except Exception as e:
        print(f"single-table bench failed: {e!r}", file=sys.stderr)
        one_bps = one_cps = float("nan")
    # emitted now, so a failure of a later phase cannot discard it
    print(f"# single-table n=2^20: {one_bps/1e9:.3f} GB/s = "
          f"{one_bps/bw*100:.3g}% of the {bw/1e9:.0f} GB/s copy roofline, "
          f"{one_cps/1e9:.3f} Gcells/s", file=sys.stderr)
    try:
        fill_bps, fill_cps = fill_throughput()
    except Exception as e:                      # keep the contract line
        print(f"fill bench failed: {e!r}", file=sys.stderr)
        print(_contract(0.0, bw))
        return
    try:
        sps = sampler_throughput()
    except Exception as e:
        print(f"sampler bench failed: {e!r}", file=sys.stderr)
        sps = float("nan")
    try:
        L, ctw_ips, ti_ips = sweep_throughput()
        print(f"# sweep scale (N={L} items, 32 chains): CTW(rel,w=10) "
              f"{ctw_ips:.4g} item-updates/s; staged TI {ti_ips:.4g} "
              f"item-updates/s", file=sys.stderr)
    except Exception as e:
        print(f"sweep bench failed: {e!r}", file=sys.stderr)

    print(f"# grid fill: {fill_bps/1e9:.3f} GB/s = {fill_bps/bw*100:.3g}% "
          f"roofline, {fill_cps/1e9:.3f} Gcells/s; (a,b) samples/s: "
          f"{sps:.4g} (target 1e5)", file=sys.stderr)
    print(_contract(fill_bps, bw))


if __name__ == "__main__":
    main()
