"""L3 hyperparameter posterior samplers for PYP/DP models.

Reproduces the capabilities of lib/sampleb.c and lib/samplea.c, batched
over chains:

* ``sample_b`` -- concentration posterior with Gamma(shape, scale) prior
  and the auxiliary-variable trick q_i ~ Beta(b, N_i) (sampleb.c:90-100);
  conjugate Gamma draw at a==0 (sampleb.c:101-118; we draw the exact Gamma
  instead of the reference's >400 Gaussian shortcut -- that was a CPU
  speed hack), slice sampling with a Newton/digammaInv warm start
  (sampleb.c:51-68,140-153) for a>0.

* ``sample_a`` -- discount posterior (samplea.c:46-83,155-225).  The
  reference rebuilds the full S table per density evaluation
  (samplea.c:57-60); here the Stirling term is precomputed as a per-chain
  curve over the discount grid (agrid.data_curve) so each evaluation is a
  cubic interpolation -- no fills in the loop, every chain has its own
  discount.

* ``sample_a_rebuild`` -- the direct transliteration-in-semantics oracle
  (table refilled per evaluation, exactly aterms) used to validate the
  grid path; f64/CPU-oriented.

All samplers take/return batched arrays; none mutate state.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..core import agrid, special, stirling
from . import ars as arsmod
from . import slice as slicemod


def _mcmc_1d(logpost, key, x0, lo, hi, loops: int, kernel: str,
             with_info: bool = False):
    """Dispatch the 1-D kernel: "slice" (sslice.c route, the default)
    or "ars" (PSAMPLE_ARS route, psample.h:31-37).  ``with_info`` returns
    a third element: the per-chain density-evaluation count for ARS (the
    arms.c neval telemetry), 0 for the slice kernel (the reference
    exposes no equivalent there)."""
    if kernel == "ars":
        return arsmod.ars_sample(logpost, key, lo, hi, x_prev=x0,
                                 with_info=with_info)
    out = slicemod.slice_sample(logpost, key, x0, lo, hi, loops=loops)
    if with_info:
        return out[0], out[1], jnp.zeros_like(out[0], jnp.int32)
    return out

__all__ = ["A_MIN", "A_MAX", "SQUEEZEA", "B_MIN", "B_MAX",
           "sample_b", "sample_a", "sample_a_rebuild", "sample_a_m",
           "sample_table_config", "a_bounds"]

# psample.h:54-59, 87-94
B_MIN = 0.01
B_MAX = 2000.0
A_MIN = 0.01
A_MAX = 0.98
SQUEEZEA = 0.2


def _conc_terms(x, T, b):
    """sum_i [ T_i log x + lgamma(T_i + b_i/x) - lgamma(b_i/x) ]
    (samplea.c:65-67), batched; x broadcasts against the group axis."""
    xT = x[..., None]
    y = b / xT
    val = (T * jnp.log(xT) + jax.lax.lgamma(T + y) - jax.lax.lgamma(y))
    return jnp.sum(val, axis=-1)


def a_bounds(a0):
    """Start clamping + SQUEEZEA move bounds (samplea.c:161-177)."""
    mid = jnp.clip(a0, A_MIN * 0.999 + A_MAX * 0.001,
                   A_MAX * 0.999 + A_MIN * 0.001)
    lo = jnp.where(mid - SQUEEZEA > A_MIN, mid - SQUEEZEA, A_MIN)
    hi = jnp.where(mid + SQUEEZEA < A_MAX, mid + SQUEEZEA, A_MAX)
    return mid, lo, hi


def sample_a(key, a0, grid: agrid.AGridTable, ns, ts, T, b,
             loops: int = 1, kernel: str = "slice",
             sparse_chunk: Optional[int] = None):
    """Discount posterior step using the grid curve (samplea semantics).

    Args:
      a0: (C,) current discounts.
      ns, ts: (C, P) or (P,) count/table pairs (flattened over groups and
        categories; zero-padded entries are masked by n<=1).  For large
        sparse workloads pass OCCUPIED pairs only (the getval capability,
        psample.h:101-115) -- beyond ~2^18 pairs the curve reduction
        streams in chunks automatically; ``sparse_chunk`` forces the
        chunk size.
      T: (C, I) per-group table totals; b: (C, I) or (I,) concentrations.
    Returns (a, ok).
    """
    a0 = jnp.asarray(a0)
    T = jnp.asarray(T, a0.dtype)
    b = jnp.broadcast_to(jnp.asarray(b, a0.dtype), T.shape)
    ns = jnp.asarray(ns)
    ts = jnp.asarray(ts)
    if sparse_chunk is None and ns.shape[-1] >= (1 << 18):
        sparse_chunk = 1 << 16
    if sparse_chunk:
        curve = grid.data_curve_sparse(ns, ts, chunk=sparse_chunk)
    else:
        curve = grid.data_curve(ns, ts)
    if curve.ndim == 1:                    # shared data pairs across chains
        curve = jnp.broadcast_to(curve, a0.shape + curve.shape)

    def logpost(x):
        return _conc_terms(x, T, b) + grid.curve_at(curve, x)

    mid, lo, hi = a_bounds(a0)
    return _mcmc_1d(logpost, key, mid, lo, hi, loops, kernel)


def sample_a_rebuild(key, a0, ns, ts, T, b, n_max: int, m_max: int,
                     loops: int = 1, dtype=jnp.float64):
    """Oracle discount sampler: refills the table inside every density
    evaluation, exactly like aterms (samplea.c:46-83).  Single chain or
    small batches; meant for f64/CPU validation of sample_a."""
    a0 = jnp.asarray(a0, dtype)
    ns = jnp.asarray(ns)
    ts = jnp.asarray(ts)
    T = jnp.asarray(T, dtype)
    b = jnp.broadcast_to(jnp.asarray(b, dtype), T.shape)

    def s_terms(x):
        """Scalar x -> scalar: refill the table at discount x and sum the
        log-S terms (the S_remake + S_S sum of aterms)."""
        _, srel, _ = stirling.fill_rows(x, n_max, m_max, dtype=dtype,
                                        with_srel=True)
        s1 = stirling.s1_ingraph(x, n_max, dtype)
        i = jnp.clip(ns - 1, 0, n_max - 1)
        j = jnp.clip(ts - 1, 0, m_max - 1)
        vals = s1[i] + srel[i, j]
        vals = jnp.where(ns == ts, 0.0, vals)
        vals = jnp.where(ts == 1, s1[i], vals)
        return jnp.sum(
            jnp.where((ns > 1) & (ts >= 1) & (ts <= ns), vals, 0.0))

    def logpost(x):
        return _conc_terms(x, T, b) + jax.vmap(s_terms)(x)

    mid, lo, hi = a_bounds(jnp.atleast_1d(a0))
    return slicemod.slice_sample(logpost, key, mid, lo, hi, loops=loops)


def _pair_S(tab, n, m, a):
    """log S query batched over chains with per-chain discounts."""
    if isinstance(tab, agrid.AGridTable):
        return tab.S(n, m, a)
    return tab.S(n, m)


def sample_table_config(key, tab, ns, ts, a, max_t: int, max_n: int):
    """Sample the table-size configuration (samplea2, samplea.c:293-323).

    For each (chain, pair) with 1 < t < n, draws the sizes of the t
    tables from their exact posterior given (n, t) by peeling one table
    at a time:  P(size = l | N remaining, M tables left) proportional to

        exp( sum_{j=2..l} log((j-a)(N-j+1)/(j-1)) ) S(N-l, M) / S(N, M+1)

    The reference's sequential log-CDF subtraction loop (samplea.c:
    303-317) becomes one Gumbel-max categorical over l = 1..max_n per
    step, vectorised over chains x pairs; the t-1 peeling steps run as a
    lax.scan of length max_t-1.

    Returns ``hist``: (C, max_n+1) counts of table sizes (index = size),
    aggregated over pairs, INCLUDING the t==1 whole-pair table of size n
    (aterms2's t==1 branch) and excluding t==n pairs (all singletons).

    Args:
      ns, ts: (C, P) int32 counts; a: (C,) discounts; tab: AGridTable or
      StirlingTable covering (max_n, max_t).

    ``max_t`` must be >= max(ts) + 1 and ``max_n`` >= max(ns): the peel
    scan runs max_t - 1 steps, so a smaller max_t silently lumps the
    unpeeled tables into one oversized remainder, skewing the size
    histogram.  The reference derives maxt from the data for this reason
    (samplea.c:277-284); do the same at the call site.  Concrete
    (non-traced) inputs are checked here.
    """
    ns = jnp.asarray(ns)
    ts = jnp.asarray(ts)
    if not isinstance(ts, jax.core.Tracer) and ts.size:
        if int(jnp.max(ts)) + 1 > max_t:
            raise ValueError(
                f"max_t={max_t} < max(ts)+1={int(jnp.max(ts)) + 1}: the "
                "peel scan would truncate table configurations")
        if int(jnp.max(ns)) > max_n:
            raise ValueError(f"max_n={max_n} < max(ns)={int(jnp.max(ns))}")
    a = jnp.asarray(a)
    dt = a.dtype
    C, P = ns.shape
    L = max_n
    lvec = jnp.arange(1, L + 1)                       # candidate sizes
    jf = lvec.astype(dt)

    active_pair = (ts > 1) & (ts < ns)
    ptot_all = _pair_S(tab, ns, ts, a[:, None])       # (C, P) -- unused
    del ptot_all                                      # (normalisation drops)

    def step(carry, s):
        N, key = carry                                # N: (C, P) remaining
        M = ts - 1 - s                                # tables left after this
        live = active_pair & (M >= 1)
        # fact(l) = sum_{j=2..l} log((j - a)(N - j + 1)/(j - 1))
        terms = (jnp.log(jnp.maximum(jf[None, None] - a[:, None, None],
                                     1e-12))
                 + jnp.log(jnp.maximum(
                     N[..., None].astype(dt) - jf[None, None] + 1.0, 1e-12))
                 - jnp.log(jnp.maximum(jf[None, None] - 1.0, 1e-12)))
        terms = jnp.where(lvec[None, None] >= 2, terms, 0.0)
        fact = jnp.cumsum(terms, axis=-1)
        logS = _pair_S(tab, N[..., None] - lvec[None, None],
                       M[..., None], a[:, None, None])
        logw = fact + logS
        ok = (lvec[None, None] <= N[..., None] - M[..., None])
        logw = jnp.where(ok & live[..., None], logw, -jnp.inf)
        key, kg = jax.random.split(key)
        g = jax.random.gumbel(kg, logw.shape, dt)
        l = (1 + jnp.argmax(logw + g, axis=-1)).astype(N.dtype)  # (C, P)
        l = jnp.where(live, l, 0)
        return (N - l, key), l

    (N_rem, _), sizes = jax.lax.scan(
        step, (ns, key), jnp.arange(max_t - 1))       # sizes: (S, C, P)

    # histogram over sizes 2..max_n (size-1 tables contribute nothing)
    def hist_of(vals, live):
        oh = jax.nn.one_hot(jnp.where(live, vals, 0), L + 1, dtype=dt)
        return jnp.sum(oh * live[..., None].astype(dt), axis=1)  # (C, L+1)

    hist = jnp.zeros((C, L + 1), dt)
    live_steps = active_pair[None] & (ts[None] - 1
                                      - jnp.arange(max_t - 1)[:, None, None]
                                      >= 1)
    for_scan = jnp.moveaxis(sizes, 0, 0)
    def acc(h, inp):
        v, lv = inp
        return h + hist_of(v, lv), None
    hist, _ = jax.lax.scan(acc, hist, (for_scan, live_steps))
    # remainder table of each active pair
    hist = hist + hist_of(N_rem, active_pair)
    # t == 1 pairs: one table of size n
    hist = hist + hist_of(jnp.minimum(ns, L), (ts == 1) & (ns >= 1))
    return hist


def sample_a_m(key, a0, tab, ns, ts, T, b, max_t: int, max_n: int,
               loops: int = 1):
    """Discount step via the SAMPLEA_M config route (samplea2,
    samplea.c:244-340): sample the table configuration once, then slice
    sample ``a`` on the S-table-FREE posterior aterms2 (samplea.c:87-149)

        conc_terms(a) + sum_{sizes s >= 2} hist_s (lgamma(s - a)
                                                   - lgamma(1 - a)).

    Each density evaluation is an O(max_n) dot product -- no table fills,
    no table gathers -- which is why the reference calls this route
    "usually 70% faster" (psample.h:22-29).
    """
    a0 = jnp.asarray(a0)
    dt = a0.dtype
    kc, ks = jax.random.split(key)
    hist = sample_table_config(kc, tab, ns, ts, a0, max_t, max_n)
    T = jnp.asarray(T, dt)
    b = jnp.broadcast_to(jnp.asarray(b, dt), T.shape)
    svec = jnp.arange(max_n + 1, dtype=dt)
    use = (jnp.arange(max_n + 1) >= 2).astype(dt)

    def logpost(x):
        lg = jax.lax.lgamma(jnp.maximum(svec[None] - x[:, None], 1e-12))
        lg1a = jax.lax.lgamma(1.0 - x)
        ntab = jnp.sum(hist * use[None], axis=-1)
        stir = jnp.sum(hist * use[None] * lg, axis=-1) - ntab * lg1a
        return _conc_terms(x, T, b) + stir

    mid, lo, hi = a_bounds(a0)
    return slicemod.slice_sample(logpost, ks, mid, lo, hi, loops=loops)


def _bterms(x, Q, T, shape, a):
    """Concentration log posterior for a>0 (sampleb.c:33-41)."""
    safe_a = jnp.where(a > 0, a, 1.0)
    y = (x / safe_a)[..., None]
    val = -Q * x + (shape - 1.0) * jnp.log(x)
    val = val + jnp.sum(
        jax.lax.lgamma(T + y) - jax.lax.lgamma(y), axis=-1)
    return val


def _bmax(x, Q, T, shape, a, iters: int = 5):
    """Newton warm start for the slice sampler (sampleb.c:51-68)."""
    safe_a = jnp.where(a > 0, a, 1.0)
    I = T.shape[-1]

    def body(_, x):
        val = ((shape - 1.0) * safe_a / x - Q * safe_a
               + jnp.sum(special.digamma(T + (x / safe_a)[..., None]), axis=-1))
        return (safe_a * special.digamma_inv(val / I)).astype(x.dtype)

    out = jax.lax.fori_loop(0, iters, body, x * 1.1)
    return jnp.clip(out, B_MIN, B_MAX)


def sample_b(key, b0, N, T, a, shape: float, scale: float,
             loops: int = 1, kernel: str = "slice",
             with_info: bool = False):
    """Concentration posterior step (sampleb.c:79-159), batched.

    Args:
      b0: (C,) current values; N, T: (C, I) or (I,) group totals;
      a: (C,) discounts (mixed a==0 / a>0 chains are handled by computing
      both the conjugate and the slice path and selecting).
    Returns (b, ok).
    """
    b0 = jnp.asarray(b0)
    dt = b0.dtype
    a = jnp.broadcast_to(jnp.asarray(a, dt), b0.shape)
    N = jnp.asarray(N, dt)
    T = jnp.asarray(T, dt)
    if N.ndim < b0.ndim + 1:
        N = jnp.broadcast_to(N, b0.shape + N.shape[-1:])
    if T.ndim < b0.ndim + 1:
        T = jnp.broadcast_to(T, b0.shape + T.shape[-1:])

    kq1, kq2, kg, ks = jax.random.split(key, 4)
    # auxiliary variables (sampleb.c:90-100); N_i==0 groups contribute 0.
    # q ~ Beta(b, N_i) can underflow to 0 in f32 for small b (the reference
    # exits(1) on that, sampleb.c:96-98); we sample log q directly via
    # log-gamma:  q = G(b)/(G(b)+G(N)) => log q = lg1 - logaddexp(lg1, lg2).
    bshape = jnp.broadcast_shapes(b0[..., None].shape, N.shape)
    lg1 = jax.random.loggamma(kq1, jnp.broadcast_to(
        jnp.maximum(b0[..., None], B_MIN * 1e-3), bshape))
    lg2 = jax.random.loggamma(kq2, jnp.broadcast_to(jnp.maximum(N, 1.0), bshape))
    logq = lg1 - jnp.logaddexp(lg1, lg2)
    logq = jnp.where(N > 0, logq, 0.0)
    Q = 1.0 / scale - jnp.sum(logq, axis=-1)

    # a == 0: conjugate Gamma (sampleb.c:101-118)
    Tsum = shape + jnp.sum(T, axis=-1)
    conj = jax.random.gamma(kg, Tsum) / Q
    conj = jnp.clip(conj, B_MIN, B_MAX)

    # a > 0: slice / ARS on bterms (sampleb.c:119-153).
    def logpost(x):
        return _bterms(x, Q, T, shape, a)

    if kernel == "ars":
        # ARS over the full [B_MIN, B_MAX] range wastes envelope points on
        # a 2000-wide domain; bound it around the Newton mode like the
        # reference's ARS setup does via its initial points
        # (sampleb.c:125-131).  ARS draws are (approximately) independent
        # conditional draws, so a mode-informed window is safe.
        mode = _bmax(jnp.clip(b0, B_MIN, B_MAX), Q, T, shape, a)
        lo = jnp.maximum(mode * 0.05, B_MIN)
        hi = jnp.minimum(mode * 20.0 + 1.0, B_MAX)
        start = mode
    else:
        # The slice transition must start at the CURRENT value: starting
        # at the Newton mode (as the reference's non-default slice path
        # does, sampleb.c:140-146) breaks detailed balance -- shrinkage
        # toward a mode start over-samples the mode and biased E[b] low
        # by ~15% on the demo workload (found vs the ARS-built reference
        # binary, tools/oracle_compare.py).
        lo = jnp.full_like(b0, B_MIN)
        hi = jnp.full_like(b0, B_MAX)
        start = jnp.clip(b0, B_MIN, B_MAX)
    res = _mcmc_1d(logpost, ks, start, lo, hi, loops, kernel,
                   with_info=with_info)
    sliced, ok = res[0], res[1]

    out = jnp.where(a > 0, sliced, conj)
    if with_info:
        # conjugate (a==0) chains draw exactly, no density evals
        return out, ok | (a <= 0), jnp.where(a > 0, res[2], 0)
    return out, ok | (a <= 0)
