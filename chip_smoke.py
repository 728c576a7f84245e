#!/usr/bin/env python
"""Smoke test of the main path on the GPU, each phase against its reference.

Run from the repository root:

    python chip_smoke.py              # one GPU: phases 1-5
    python chip_smoke.py --devices 4  # four GPUs: the sharded phase only

Phases on one GPU, all through the public entry points:

1. device -- JAX must see GPUs (there is no CPU fallback); the card's name
   and power limit come from nvidia-smi.
2. table  -- ``stirling.make`` at the north-star size (n = 2^20, M = 1024)
   against the long-double oracle ``native.fill_ref``: every n for the
   first 64 columns, and a full-width block at n <= 2^14; V/S/Srel point
   queries; ``stirling.ensure`` growth 2^19 -> 2^20 against the fresh table.
3. grid   -- ``agrid.make_grid(2^14, 1024, g=64)`` against ``stirling.make``
   at the same discounts and against ``native.fill_ref``.
4. gibbs  -- ``driver.run_gibbs`` at check.c scale (N = 10^5 items, 1024
   chains, bcycle=2, acycle=5); then, at demo.c scale, the f32 GPU result
   against a float64 CPU run of the same program in a child process pinned
   to the CPU (it never opens the card).
5. hyper  -- joint (a, b) sampling at 4096 chains; the contraction route of
   ``AGridTable.data_curve`` against its gather route at m_max 128 and 512;
   steps of ``__graft_entry__.entry()``.

With ``--devices 4``: ``__graft_entry__.dryrun_multichip(4)`` against the
same step on one GPU from the same inputs, and ``make_grid`` over a 4-GPU
mesh against the one-GPU grid.

Every phase prints its sizes, seconds and each error beside its tolerance.
A failed check raises, so the script exits non-zero.  The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# north-star single table (BASELINE.md: fill log S(n, m; a) to n ~ 10^6)
TABLE_N, TABLE_M = 1 << 20, 1024
# the discount grid: G x N x M = 64 x 2^14 x 1024 (8.6 GB of V + Srel)
GRID_N, GRID_M, GRID_G = 1 << 14, 1024, 64


class SmokeError(RuntimeError):
    """A phase of the smoke test failed its check."""


def check(name: str, err: float, tol: float, detail: str = "") -> None:
    """Print ``err`` beside ``tol``; raise unless err is finite and <= tol."""
    err = float(err)
    ok = bool(np.isfinite(err)) and err <= tol
    print(f"  {name}: err={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}"
          f"{'  (' + detail + ')' if detail else ''}", flush=True)
    if not ok:
        raise SmokeError(f"{name}: error {err!r} exceeds tolerance {tol!r}")


def require_gpus(count: int):
    """The first ``count`` devices, which must be GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise SmokeError(f"need {count} GPU(s); JAX found {len(devs)} "
                         f"{devs[0].platform} device(s)")
    return devs[:count]


def _on_path():
    """Let phases import the repository's root modules (bench,
    __graft_entry__) when this file is imported from elsewhere."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)


def _wall(fn, *args, **kw):
    """(result, seconds) of fn(*args), waiting for the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Comparison metrics against the long-double oracle
# ---------------------------------------------------------------------------

# Tolerances of the f32 fill against the long-double oracle.  V is a
# recurrence along n, and its f32 rounding errors are correlated from row
# to row, so V's relative error grows about linearly in n: on the CPU's f32
# the worst cell measured 0.16-0.61 n*u (u = 2^-24) over a in [0, 0.98]
# for n <= 2^20, m <= 64.  The bound is max(3e-5, n*u) per row: 3e-5 is the
# CPU tests' rtol for n <= 512, where the two agree.
U32 = 2.0 ** -24


def v_tol(n):
    return np.maximum(3e-5, np.asarray(n, np.float64) * U32)


# Srel = sum_{j<=m} log V(n, j) adds up the V errors of its row: bound
# the error relative to max(1, |Srel|) by twice V's (worst measured 0.93).
def srel_tol(n):
    return 2.0 * v_tol(n)


# S = S1_hi + Srel + S1_lo rounds to f32 at |log S| (up to ~1.4e7 at
# n = 2^20): two roundings of at most u |log S| each, plus Srel's error.
def s_tol(n, logS, srel):
    return (2 * U32 * np.maximum(1.0, np.abs(logS))
            + srel_tol(n) * np.maximum(1.0, np.abs(srel)))


def _worst(ratio, n_of):
    """(max ratio, row n where it is reached) of a per-cell err/tol."""
    k = int(np.argmax(ratio))
    return float(ratio.reshape(-1)[k]), int(np.asarray(n_of).reshape(-1)[k])


def table_errors(vtab, srel, logS_ref, v_ref, s1_ref):
    """Per-cell error over tolerance of f32 table slices against the
    long-double reference block of the same shape (row i is n = i+1):
    ((V worst ratio, its n), (Srel worst ratio, its n))."""
    v = np.asarray(vtab, np.float64)
    s = np.asarray(srel, np.float64)
    nn = np.broadcast_to(np.arange(1, v.shape[0] + 1)[:, None], v.shape)
    live = np.isfinite(v_ref) & (v_ref > 0)
    v_rat = np.abs(v[live] - v_ref[live]) / v_ref[live] / v_tol(nn[live])
    sref = logS_ref - s1_ref[:, None]
    fin = np.isfinite(sref)
    if not np.array_equal(np.isfinite(s), fin):
        return _worst(v_rat, nn[live]), (np.inf, 0)   # -inf pattern differs
    s_rat = (np.abs(s[fin] - sref[fin]) / np.maximum(1.0, np.abs(sref[fin]))
             / srel_tol(nn[fin]))
    return _worst(v_rat, nn[live]), _worst(s_rat, nn[fin])


def query_errors(tab, n, m, logS_ref, v_ref, s1_ref):
    """Worst error over tolerance of the V / S / Srel point queries at
    (n, m) against the reference arrays indexed [n-1, m-1]."""
    i, j = n - 1, m - 1
    vq = np.asarray(tab.V(n, m), np.float64)
    sq = np.asarray(tab.S(n, m), np.float64)
    rq = np.asarray(tab.Srel(n, m), np.float64)
    vr = np.where(m >= 2, v_ref[i, j], 0.0)
    sr = logS_ref[i, j]
    rr = sr - s1_ref[i]
    v_rat = np.abs(vq - vr) / np.maximum(vr, 1e-30) / v_tol(n)
    s_rat = np.abs(sq - sr) / s_tol(n, sr, rr)
    r_rat = np.abs(rq - rr) / np.maximum(1.0, np.abs(rr)) / srel_tol(n)
    return _worst(v_rat, n), _worst(s_rat, n), _worst(r_rat, n)


def same_table(x, y, floor: float) -> float:
    """On the device: max |x - y| / max(floor, |y|) over y's finite cells,
    or inf where the two disagree on which cells are finite."""
    import jax.numpy as jnp

    fin = jnp.isfinite(y)
    d = jnp.where(fin, jnp.abs(x - y) / jnp.maximum(floor, jnp.abs(y)), 0.0)
    same = jnp.all((jnp.isfinite(x) == fin) & (fin | (x == y)))
    return float(jnp.where(same, jnp.max(d), jnp.inf))


def check_ratio(name, worst, what):
    ratio, n = worst
    check(name, ratio, 1.0, f"err/tol, worst at n={n}; tol {what}")


V_WHAT = "max(3e-5, n*u) rel"
SREL_WHAT = "2 max(3e-5, n*u) rel to max(1,|Srel|)"
S_WHAT = "2u|log S| + Srel's"


# ---------------------------------------------------------------------------
# Phase 2: the single table
# ---------------------------------------------------------------------------

def phase_table(n: int = TABLE_N, m: int = TABLE_M, a: float = 0.5,
                ref_cols: int = 64, block_n: int = 1 << 14,
                queries: int = 4096, seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp

    from libstb_jax import native
    from libstb_jax.core import stirling

    print(f"[table] stirling.make({n}, {m}, {2 * n}, {2 * m}, a={a}, "
          f"use_asympt=True) f32", flush=True)
    t0 = time.perf_counter()
    stirling.fill_rows.lower(jnp.float32(a), n, m, dtype=jnp.float32,
                             with_srel=True).compile()
    t_compile = time.perf_counter() - t0
    tab, t_make = _wall(stirling.make, n, m, 2 * n, 2 * m, a,
                        use_asympt=True)
    gbs = 8 * n * m / t_make / 1e9
    print(f"  fill_rows compile {t_compile:.3f} s; make wall {t_make:.3f} s "
          f"= {gbs:.3f} GB/s written (8 B/cell)", flush=True)

    t0 = time.perf_counter()
    logS_c, v_c, s1 = native.fill_ref(a, n, ref_cols)
    logS_b, v_b, _ = native.fill_ref(a, block_n, m)
    print(f"  native.fill_ref ({n}x{ref_cols} + {block_n}x{m}) "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    v_w, s_w = table_errors(tab.vtab[:, :ref_cols], tab.srel[:, :ref_cols],
                            logS_c, v_c, s1)
    check_ratio(f"V, n<={n}, m<={ref_cols}", v_w, V_WHAT)
    check_ratio(f"Srel, n<={n}, m<={ref_cols}", s_w, SREL_WHAT)
    v_w, s_w = table_errors(tab.vtab[:block_n], tab.srel[:block_n],
                            logS_b, v_b, s1[:block_n])
    check_ratio(f"V, n<={block_n}, m<={m}", v_w, V_WHAT)
    check_ratio(f"Srel, n<={block_n}, m<={m}", s_w, SREL_WHAT)

    rng = np.random.default_rng(seed)
    for label, nn, mm, lS, vr in (
            (f"m<={ref_cols}", n, ref_cols, logS_c, v_c),
            (f"n<={block_n}", block_n, m, logS_b, v_b)):
        qn = rng.integers(1, nn + 1, queries)
        qm = np.minimum(rng.integers(1, mm + 1, queries), qn)
        v_w, s_w, r_w = query_errors(tab, qn, qm, lS, vr, s1)
        check_ratio(f"V query, {label}", v_w, V_WHAT)
        check_ratio(f"S query, {label}", s_w, S_WHAT)
        check_ratio(f"Srel query, {label}", r_w, SREL_WHAT)
    del logS_c, v_c, logS_b, v_b

    # N-growth: resume from the 2^19 frontier row, against the fresh table
    small = stirling.make(n // 2, m, 2 * n, 2 * m, a, use_asympt=True)
    grown, t_grow = _wall(stirling.ensure, small, n - 1, m - 1)
    del small
    if grown.n_max != n or grown.m_max != m:
        raise SmokeError(f"ensure grew to ({grown.n_max}, {grown.m_max}), "
                         f"expected ({n}, {m})")
    print(f"  ensure({n // 2} -> {n}) {t_grow:.3f} s", flush=True)
    # same recurrence from the same frontier row: equal up to how XLA
    # compiles the two programs
    check("ensure vs fresh V (rel)", same_table(grown.vtab, tab.vtab, 1e-30),
          1e-6)
    check("ensure vs fresh Srel (rel to max(1,|Srel|))",
          same_table(grown.srel, tab.srel, 1.0), 1e-6)
    return dict(make_s=t_make, gbs=gbs, ensure_s=t_grow)


# ---------------------------------------------------------------------------
# Phase 3: the discount grid
# ---------------------------------------------------------------------------

def phase_grid(n: int = GRID_N, m: int = GRID_M, g: int = GRID_G,
               picks=(1, 21, 42, 62), ref_cols: int = 64) -> dict:
    import jax.numpy as jnp

    from libstb_jax import native
    from libstb_jax.core import agrid, stirling

    print(f"[grid] agrid.make_grid({n}, {m}, g={g}) f32", flush=True)
    grid, dt_first = _wall(agrid.make_grid, n, m, g=g)
    del grid
    grid, dt = _wall(agrid.make_grid, n, m, g=g)
    gbs = 8 * g * n * m / dt / 1e9
    print(f"  make_grid wall {dt_first:.3f} s (compile included), then "
          f"{dt:.3f} s = {gbs:.3f} GB/s written", flush=True)
    avec = np.asarray(grid.avec)
    for gi in picks:
        a = float(avec[gi])                  # the f32 discount the grid used
        tab = stirling.make(n, m, n, m, a)
        # the same fill_rows, vmapped or not
        check(f"grid[{gi}] (a={a:.4f}) vs make: V (rel)",
              same_table(grid.vtab[gi], tab.vtab, 1e-30), 1e-6)
        check(f"grid[{gi}] vs make: Srel (rel to max(1,|Srel|))",
              same_table(grid.srel[gi], tab.srel, 1.0), 1e-6)
        logS, v_ref, s1 = native.fill_ref(a, n, ref_cols)
        v_w, s_w = table_errors(grid.vtab[gi, :, :ref_cols],
                                grid.srel[gi, :, :ref_cols], logS, v_ref, s1)
        check_ratio(f"grid[{gi}] vs fill_ref: V, m<={ref_cols}", v_w, V_WHAT)
        check_ratio(f"grid[{gi}] vs fill_ref: Srel, m<={ref_cols}", s_w,
                    SREL_WHAT)
    return dict(grid_s=dt, gbs=gbs)


# ---------------------------------------------------------------------------
# Phase 4: Gibbs runs
# ---------------------------------------------------------------------------

def _crp(seed, n_groups, dim, n_per_group, a, b):
    """check.c-style data, from the native generator when it builds."""
    from libstb_jax import native
    from libstb_jax.models import pyp

    if native.available():
        return native.crp_generate(seed, n_groups, dim, n_per_group, a, b)
    return pyp.crp_generate(seed, n_groups, dim, n_per_group, a, b)


def phase_gibbs(n_groups: int = 100, n_per_group: int = 1000, dim: int = 20,
                chains: int = 1024, iters: int = 200, seed: int = 1) -> dict:
    import jax

    from libstb_jax.core import agrid
    from libstb_jax.models import driver
    from libstb_jax.utils import config

    data = _crp(seed, n_groups, dim, n_per_group, 0.5, 10.0)
    L = data.data_cat.size
    n_req, m_req = agrid.required_dims(data.n)
    print(f"[gibbs] run_gibbs: N={L} items ({n_groups} groups x "
          f"{n_per_group}, dim {dim}), {chains} chains, {iters} iterations, "
          f"bcycle=2 acycle=5", flush=True)
    # the CLI's default grid (cli/check.py), grown by the ensure_grid call
    # run_gibbs makes itself -- timed here, so run_gibbs finds it sized
    tc = config.TableConfig()
    grid = agrid.make_grid(tc.init_n, tc.init_m, g=tc.grid_points,
                           a_lo=tc.a_lo, a_hi=tc.a_hi, max_n=tc.max_n,
                           max_m=tc.max_m)
    grid, dt = _wall(agrid.ensure_grid, grid, n_req, m_req)
    cells = grid.g_max * grid.n_max * grid.m_max
    _, dt_warm = _wall(agrid.make_grid, grid.n_max, grid.m_max,
                       g=grid.g_max, a_lo=tc.a_lo, a_hi=tc.a_hi)
    print(f"  ensure_grid -> G={grid.g_max} N={grid.n_max} M={grid.m_max}: "
          f"{dt:.3f} s (compile included); the same fill again {dt_warm:.3f}"
          f" s = {8 * cells / dt_warm / 1e9:.3f} GB/s written", flush=True)
    cfg = driver.GibbsConfig(iters=iters, bcycle=2, acycle=5,
                             scale=float(dim))
    out, dt = _wall(driver.run_gibbs, jax.random.key(seed), data, grid,
                    chains, 0.5, 10.0, cfg)
    print(f"  run_gibbs wall {dt:.3f} s (compile included) = "
          f"{chains * L * iters / dt:.4g} item-updates/s", flush=True)
    means = {k: np.asarray(out[k]) for k in
             ("tave_mean", "Tave_mean", "aave_mean", "bave_mean")}
    bad = sum(int(np.sum(~np.isfinite(v))) for v in means.values())
    a_m, b_m = float(means["aave_mean"]), float(means["bave_mean"])
    print(f"  E[a]={a_m:.4f} E[b]={b_m:.4f} "
          f"E[T_j] mean={float(means['Tave_mean'].mean()):.3f}", flush=True)
    check("posterior means: non-finite entries", bad, 0)
    check("E[a] outside (0, 1)", 0.0 if 0.0 < a_m < 1.0 else 1.0, 0)
    check("E[b] not positive", 0.0 if b_m > 0.0 else 1.0, 0)
    return dict(run_s=dt, a=a_m, b=b_m)


def gibbs_moments(n_groups: int, n_per_group: int, dim: int, chains: int,
                  iters: int, seed: int, dtype: str) -> dict:
    """Per-chain posterior means (T_j, a, b) of the demo.c-style run on
    the default device in ``dtype``; the statistical check runs this on
    the GPU in f32 and in a CPU child process in f64."""
    import jax
    import jax.numpy as jnp

    from libstb_jax.core import agrid
    from libstb_jax.models import driver, pyp

    data = pyp.crp_generate(seed, n_groups, dim, n_per_group, 0.5, 10.0)
    n_max = max(64, 1 << int(np.ceil(np.log2(int(data.N.max()) + 2))))
    grid = agrid.make_grid(n_max, n_max, g=96, dtype=jnp.dtype(dtype))
    cfg = driver.GibbsConfig(iters=iters, bcycle=2, acycle=5,
                             scale=float(dim))
    out = driver.run_gibbs(jax.random.key(seed + 1), data, grid, chains,
                           0.5, 10.0, cfg)
    return dict(T=np.asarray(out["Tave"], np.float64).tolist(),
                a=np.asarray(out["aave"], np.float64).tolist(),
                b=np.asarray(out["bave"], np.float64).tolist())


def _f64_reference(params: dict) -> dict:
    """gibbs_moments in float64 in a child process pinned to the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    code = ("import json, sys; import jax; "
            "jax.config.update('jax_enable_x64', True); "
            f"sys.path.insert(0, {HERE!r}); import chip_smoke; "
            "print(json.dumps(chip_smoke.gibbs_moments("
            "**json.loads(sys.argv[1]), dtype='float64')))")
    res = subprocess.run([sys.executable, "-c", code, json.dumps(params)],
                         env=env, capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        raise SmokeError(f"f64 CPU reference failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


# floors added to the 2-MC-SE band, as in tools/oracle_compare.py
STAT_FLOORS = dict(T=0.05, a=0.01, b=0.05)


def phase_stat(n_groups: int = 4, n_per_group: int = 100, dim: int = 20,
               chains: int = 1024, iters: int = 400, seed: int = 7) -> dict:
    params = dict(n_groups=n_groups, n_per_group=n_per_group, dim=dim,
                  chains=chains, iters=iters, seed=seed)
    print(f"[stat] demo.c scale ({n_groups} groups x {n_per_group}, dim "
          f"{dim}), {chains} chains, {iters} iterations: f32 here vs f64 "
          f"on the CPU", flush=True)
    t0 = time.perf_counter()
    ours = gibbs_moments(**params, dtype="float32")
    t_ours = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = _f64_reference(params)
    print(f"  f32 run {t_ours:.3f} s; f64 CPU reference "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    worst = {}
    for k in ("T", "a", "b"):
        o = np.asarray(ours[k]).reshape(chains, -1)
        r = np.asarray(ref[k]).reshape(chains, -1)
        se = np.sqrt(o.var(0, ddof=1) / chains + r.var(0, ddof=1) / chains)
        band = 2.0 * se + STAT_FLOORS[k]
        diff = np.abs(o.mean(0) - r.mean(0))
        print(f"  E[{k}]: f32={np.round(o.mean(0), 4)} "
              f"f64={np.round(r.mean(0), 4)} band={np.round(band, 4)}",
              flush=True)
        worst[k] = float(np.max(diff / band))
        check(f"E[{k}] |f32 - f64| / (2 MC-SE + {STAT_FLOORS[k]})", worst[k],
              1.0)
    return worst


# ---------------------------------------------------------------------------
# Phase 5: hyperparameters and the composite step
# ---------------------------------------------------------------------------

def curve_terms(grid, ns, ts):
    """The (G, C, P) f32 log-S terms data_curve sums, with its identities
    (t == n -> 0, t == 1 -> S1) and mask (n > 1, 1 <= t <= n) applied: a
    plain host reference built from the grid's arrays."""
    i = np.clip(ns - 1, 0, grid.n_max - 1)
    j = np.clip(ts - 1, 0, grid.m_max - 1)
    s1 = np.asarray(grid.s1_hi)[:, i] + np.asarray(grid.s1_lo)[:, i]
    vals = ((np.asarray(grid.s1_hi)[:, i][:, None, :]
             + np.asarray(grid.srel)[:, i[None, :], j])
            + np.asarray(grid.s1_lo)[:, i][:, None, :])
    vals = np.where(ns == ts, np.float32(0), vals)
    vals = np.where(ts == 1, s1[:, None, :], vals)
    mask = (ns > 1) & (ts >= 1) & (ts <= ns)
    return np.where(mask, vals, np.float32(0))


# The contraction and gather routes sum the same P f32 terms in another
# order; with HIGHEST precision there is no TF32 rounding of the terms.
# Each sum is within (P-1)*u * sum|terms| of the exact sum, so the two
# routes differ by at most 2 (P-1) u sum|terms| (log S < 0 occurs for a
# near 1, so |sum| alone would not bound the rounding).


def phase_hyper(chains: int = 4096, iters: int = 32,
                curve_m=(128, 512), steps: int = 5) -> dict:
    import jax
    import jax.numpy as jnp

    from libstb_jax.core import agrid
    from libstb_jax.models import pyp

    _on_path()
    import __graft_entry__ as ge
    import bench

    print(f"[hyper] joint (a, b) sampling: {chains} chains x {iters} steps",
          flush=True)
    run, args = bench.ab_sampling(chains, iters)
    _, t_first = _wall(run, *args)
    (a, b), dt_run = _wall(run, *args)
    print(f"  first call {t_first:.3f} s (compile included); then "
          f"{dt_run:.4f} s = {chains * iters / dt_run:.4g} samples/s",
          flush=True)
    a, b = np.asarray(a), np.asarray(b)
    check("(a, b) samples outside 0<a<1, b>0",
          int(np.sum(~((a > 0) & (a < 1) & (b > 0)))), 0)

    data = pyp.crp_generate(seed=0, n_groups=4, dim=20, n_per_group=100,
                            a=0.5, b=10.0)
    rng = np.random.default_rng(5)
    ns = np.asarray(data.n.reshape(-1))
    for mm in curve_m:
        g = agrid.make_grid(512, mm, g=64)
        ts = jnp.asarray(np.floor(rng.uniform(0, 1, (chains, ns.size))
                                  * (ns + 1)).astype(np.int32))
        mm_out = np.asarray(jax.jit(g._data_curve_mm)(jnp.asarray(ns), ts),
                            np.float64)
        ga_out = np.asarray(jax.jit(g._data_curve_gather)(jnp.asarray(ns),
                                                          ts), np.float64)
        terms = np.abs(curve_terms(g, ns, np.asarray(ts)).astype(np.float64))
        scale = np.moveaxis(terms.sum(-1), 0, -1)             # (C, G)
        err = np.max(np.abs(mm_out - ga_out) / np.maximum(scale, 1e-30))
        check(f"data_curve contraction vs gather, C={chains} P={ns.size} "
              f"M={mm} (rel to sum|terms|)", err, 2 * (ns.size - 1) * U32)

    fn, args = ge.entry()
    jf = jax.jit(fn)
    key, t, T, a, b, ns_flat = args
    t0 = time.perf_counter()
    for _ in range(steps):
        key, k = jax.random.split(key)
        t, T, a, b = jf(k, t, T, a, b, ns_flat)
    jax.block_until_ready((t, T, a, b))
    print(f"  __graft_entry__.entry(): {steps} steps in "
          f"{time.perf_counter() - t0:.3f} s (compile included), "
          f"{t.shape[0]} chains", flush=True)
    t, T, a, b = map(np.asarray, (t, T, a, b))
    check("entry step: T != sum_i t", int(np.sum(T != t.sum(-1))), 0)
    check("entry step: a, b out of range / non-finite",
          int(np.sum(~((a > 0) & (a < 1) & (b > 0)))), 0)
    return dict(samples_per_s=chains * iters / dt_run)


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------

# sample_a's data-pair reduction is a psum over the "data" axis, so a
# differs from the one-card run by that summation order only
A_RTOL = 1e-5


def phase_multi(n_devices: int, grid_n: int = GRID_N, grid_m: int = GRID_M,
                grid_g: int = GRID_G) -> dict:
    import jax
    import jax.numpy as jnp

    from libstb_jax.core import agrid
    from libstb_jax.parallel import mesh as pmesh

    _on_path()
    import __graft_entry__ as ge

    print(f"[multi] dryrun_multichip({n_devices}) vs the same step on one "
          f"device", flush=True)
    (step, args, out), dt = _wall(ge.dryrun_multichip, n_devices)
    print(f"  sharded step {dt:.3f} s (compile included), "
          f"{args[1].shape[0]} chains", flush=True)
    ref = jax.jit(step)(*jax.device_put(args, jax.devices()[0]))
    t, T, a, b = map(np.asarray, out)
    rt, rT, ra, rb = map(np.asarray, ref)
    check("t differs (entries)", int(np.sum(t != rt)), 0)
    check("T differs (entries)", int(np.sum(T != rT)), 0)
    check("b differs (entries)", int(np.sum(b != rb)), 0)
    check("a (rel)", np.max(np.abs(a - ra) / np.abs(ra)), A_RTOL)

    print(f"[multi] make_grid({grid_n}, {grid_m}, g={grid_g}) over "
          f"chain_mesh({n_devices}) vs one device", flush=True)
    g4, dt4 = _wall(agrid.make_grid, grid_n, grid_m, g=grid_g,
                    mesh=pmesh.chain_mesh(n_devices))
    g1, dt1 = _wall(agrid.make_grid, grid_n, grid_m, g=grid_g)
    print(f"  {n_devices} devices {dt4:.3f} s, one device {dt1:.3f} s "
          f"(compile included)", flush=True)
    for name in ("vtab", "srel"):
        full = getattr(g1, name)
        worst = 0
        for shard in getattr(g4, name).addressable_shards:
            want = jax.device_put(full[shard.index], shard.device)
            # same vmapped fill_rows per discount: bit-equal expected
            worst += int(jnp.sum(~((shard.data == want)
                                   | (jnp.isnan(shard.data)
                                      & jnp.isnan(want)))))
        check(f"sharded grid {name} differs (entries)", worst, 0)
    return dict(step_s=dt, grid4_s=dt4, grid1_s=dt1)


# ---------------------------------------------------------------------------

def card_info() -> list:
    """nvidia-smi's name and power limit of every card."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return [line.strip() for line in res.stdout.splitlines() if line.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    t_start = time.perf_counter()
    devs = require_gpus(args.devices)
    from libstb_jax.utils import compile_cache
    print(f"[device] {devs[0].platform} {devs[0].device_kind} x"
          f"{len(jax.devices())}; compile cache {compile_cache.enable()}",
          flush=True)
    for line in card_info():
        print(line, flush=True)

    if args.devices == 4:
        phase_multi(4)
    else:
        phase_table()
        phase_grid()
        phase_gibbs()
        phase_stat()
        phase_hyper()
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
