"""Discount-grid Stirling tables: the replacement for per-eval rebuilds.

The reference's discount sampler rebuilds the WHOLE S table for every
log-density evaluation (samplea.c:57-60, flagged as the dominant cost in
SURVEY.md §3.4).  We instead fill tables once for a static grid of
discount values -- a batched fill (vmap over the grid) is embarrassingly
parallel -- and answer queries at any ``a`` by cubic (Catmull-Rom)
interpolation along the grid axis.  log S(n,m;.) and V(n,m;.) are analytic
in ``a`` on (0,1), so a ~100-point grid reproduces direct fills to ~1e-6;
``tests/test_agrid.py`` measures this.

Consequences for the sampler pipeline:
  * sample_a density evaluations become O(#data) gathers -- no fill;
  * the Gibbs sweeps query V(n,t;a) at the chain's CURRENT a, so the
    post-sample ``S_remake`` of the reference (demo.c:487) disappears;
  * every query is vmappable over chains, each with its own discount.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import stirling

__all__ = ["AGridTable", "make_grid", "ensure_grid", "required_dims"]


def _catmull_weights(t, dtype):
    """Catmull-Rom basis at offset t in [0,1] for nodes (-1, 0, 1, 2)."""
    t = t.astype(dtype)
    t2 = t * t
    t3 = t2 * t
    w0 = 0.5 * (-t3 + 2 * t2 - t)
    w1 = 0.5 * (3 * t3 - 5 * t2 + 2)
    w2 = 0.5 * (-3 * t3 + 4 * t2 + t)
    w3 = 0.5 * (t3 - t2)
    return w0, w1, w2, w3


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AGridTable:
    """Stacked Stirling tables over a uniform discount grid.

    srel[g, i, j] = log S(i+1, j+1; a_g) - S1(i+1; a_g)   (see stirling.py)
    vtab[g, i, j] = V(i+1, j+1; a_g)
    s1[g, i]      = log S^{i+1}_{1, a_g}  (f64-accurate hi+lo collapsed to
                    table dtype: S1 enters posteriors only via n-differences
                    where the common magnitude cancels).
    """
    a0: float = dataclasses.field(metadata=dict(static=True))
    da: float = dataclasses.field(metadata=dict(static=True))
    g_max: int = dataclasses.field(metadata=dict(static=True))
    n_max: int = dataclasses.field(metadata=dict(static=True))
    m_max: int = dataclasses.field(metadata=dict(static=True))
    avec: jax.Array          # (G,)
    s1_hi: jax.Array         # (G, N)
    s1_lo: jax.Array         # (G, N)
    vtab: Optional[jax.Array]   # (G, N, M)
    srel: Optional[jax.Array]   # (G, N, M)
    # hard bounds + asymptote policy (S_make's maxN/maxM + S_ASYMPT,
    # stable.h:32-44): queries beyond (n_max, m_max) fall back to the
    # asymptote / -inf / 0 conventions of stable.c:941-974 instead of
    # silently clamping.  0 means "= n_max/m_max" (filled in by make_grid).
    max_n: int = dataclasses.field(default=0, metadata=dict(static=True))
    max_m: int = dataclasses.field(default=0, metadata=dict(static=True))
    use_asympt: bool = dataclasses.field(default=True,
                                         metadata=dict(static=True))
    # debugging tag for reports/errors (S_tag, stable.h:137-138)
    tag: str = dataclasses.field(default="", metadata=dict(static=True))

    @property
    def _a_sign(self) -> str:
        """Static asymptote-branch selector: the grid's discounts span
        [a0, a0 + da (G-1)] and queries interpolate within it, so a0 > 0
        makes every effective discount positive at trace time."""
        return "pos" if self.a0 > 0 else "any"

    def _hard_n(self) -> int:
        return self.max_n if self.max_n else self.n_max

    def _hard_m(self) -> int:
        return self.max_m if self.max_m else self.m_max

    def report(self) -> str:
        """One-line stats string (S_report analog, stable.c:1025-1055)."""
        nbytes = sum(x.size * x.dtype.itemsize
                     for x in (self.vtab, self.srel, self.s1_hi, self.s1_lo)
                     if x is not None)
        name = f" '{self.tag}'" if self.tag else ""
        return (f"a-grid{name}: G={self.g_max} a=[{self.a0:g},"
                f"{self.a0 + self.da * (self.g_max - 1):g}], "
                f"N={self.n_max}/{self._hard_n()}, "
                f"M={self.m_max}/{self._hard_m()}, "
                f"{'+S' if self.srel is not None else ''}"
                f"{'+U/V' if self.vtab is not None else ''} "
                f"{np.dtype(self.s1_hi.dtype).name} mem={nbytes // 1024}k")

    # -- grid locate --------------------------------------------------------
    def _locate(self, a):
        """Return (g0, t): base index for the 4-point stencil and offset."""
        dt = self.s1_hi.dtype
        pos = (jnp.asarray(a, dt) - self.a0) / self.da
        g = jnp.clip(jnp.floor(pos).astype(jnp.int32), 1, self.g_max - 3)
        t = pos - g.astype(dt)
        return g, t

    # -- queries (each vmappable over chains with per-chain a) -------------
    def S(self, n, m, a):
        """log S^n_{m,a} by cubic interpolation (S_S, stable.c:941-974).

        Total function: n==m -> 0, m==1 -> S1, m<1 or n<m -> -inf; beyond
        (n_max, m_max) the asymptote (stable.c:951-953) when
        ``use_asympt`` else -inf -- never a silent clamp."""
        n = jnp.asarray(n)
        m = jnp.asarray(m)
        dt = self.srel.dtype
        i = jnp.clip(n - 1, 0, self.n_max - 1)
        j = jnp.clip(m - 1, 0, self.m_max - 1)
        g, t = self._locate(a)
        w = _catmull_weights(t, dt)
        acc = jnp.zeros(jnp.broadcast_shapes(n.shape, m.shape, jnp.shape(a)), dt)
        for k in range(4):
            gk = g - 1 + k
            acc = acc + w[k] * (self.s1_hi[gk, i] + self.srel[gk, i, j]
                                + self.s1_lo[gk, i])
        in_tab = (n >= 1) & (n <= self.n_max) & (m >= 1) & (m <= self.m_max)
        if self.use_asympt:
            af = jnp.asarray(a, dt)
            lga1 = jax.lax.lgamma(1.0 - af)
            asy = stirling.s_asympt(af, lga1, jnp.maximum(n, 1).astype(dt),
                                    jnp.maximum(m, 1).astype(dt),
                                    a_sign=self._a_sign)
            acc = jnp.where(in_tab, acc, asy.astype(dt))
        else:
            acc = jnp.where(in_tab, acc, -jnp.inf)
        acc = jnp.where(n == m, jnp.zeros((), dt), acc)
        acc = jnp.where(m == 1, self.S1(n, a), acc)
        return jnp.where((m < 1) | (n < m), -jnp.inf, acc)

    def Srel(self, n, m, a):
        """log S^n_{m,a} - log S^n_{1,a} (difference form; -inf-safe).
        Out-of-grid queries follow S()'s asymptote/-inf conventions."""
        n = jnp.asarray(n)
        m = jnp.asarray(m)
        dt = self.srel.dtype
        i = jnp.clip(n - 1, 0, self.n_max - 1)
        j = jnp.clip(m - 1, 0, self.m_max - 1)
        g, t = self._locate(a)
        w = _catmull_weights(t, dt)
        acc = jnp.zeros(jnp.broadcast_shapes(n.shape, m.shape, jnp.shape(a)), dt)
        for k in range(4):
            gk = g - 1 + k
            acc = acc + w[k] * self.srel[gk, i, j]
        in_tab = (n >= 1) & (n <= self.n_max) & (m >= 1) & (m <= self.m_max)
        if self.use_asympt:
            af = jnp.asarray(a, dt)
            lga1 = jax.lax.lgamma(1.0 - af)
            asy = stirling.s_asympt(af, lga1, jnp.maximum(n, 1).astype(dt),
                                    jnp.maximum(m, 1).astype(dt),
                                    a_sign=self._a_sign)
            acc = jnp.where(in_tab, acc, (asy - self.S1(n, a)).astype(dt))
        else:
            acc = jnp.where(in_tab, acc, -jnp.inf)
        acc = jnp.where(m == 1, jnp.zeros((), dt), acc)
        acc = jnp.where(n == m,
                        -self.S1(n, a), acc)
        return jnp.where((m < 1) | (n < m), -jnp.inf, acc)

    def S1(self, n, a):
        """log S^n_{1,a}; beyond the grid rows the exact lgamma formula
        (stable.h:154-160) replaces the table read."""
        n = jnp.asarray(n)
        dt = self.s1_hi.dtype
        i = jnp.clip(n - 1, 0, self.n_max - 1)
        g, t = self._locate(a)
        w = _catmull_weights(t, dt)
        acc = jnp.zeros(jnp.broadcast_shapes(n.shape, jnp.shape(a)), dt)
        for k in range(4):
            gk = g - 1 + k
            acc = acc + w[k] * (self.s1_hi[gk, i] + self.s1_lo[gk, i])
        af = jnp.asarray(a, dt)
        beyond = (jax.lax.lgamma(jnp.maximum(n, 1).astype(dt) - af)
                  - jax.lax.lgamma(1.0 - af))
        acc = jnp.where(n <= self.n_max, acc, beyond)
        return jnp.where(n >= 1, acc, -jnp.inf)

    def V(self, n, m, a):
        """V^n_{m,a} interpolated in a (S_V, stable.c:900-939): 0 out of
        domain; beyond n_max the V asymptote (stable.c:905-912) when
        ``use_asympt``, else 0."""
        n = jnp.asarray(n)
        m = jnp.asarray(m)
        dt = self.vtab.dtype
        i = jnp.clip(n - 1, 0, self.n_max - 1)
        j = jnp.clip(m - 1, 0, self.m_max - 1)
        g, t = self._locate(a)
        w = _catmull_weights(t, dt)
        acc = jnp.zeros(jnp.broadcast_shapes(n.shape, m.shape, jnp.shape(a)), dt)
        for k in range(4):
            gk = g - 1 + k
            acc = acc + w[k] * self.vtab[gk, i, j]
        in_tab = (n <= self.n_max) & (m <= self.m_max)
        if self.use_asympt:
            asy = stirling.v_asympt(jnp.asarray(a, dt),
                                    jnp.maximum(n, 2).astype(dt),
                                    jnp.maximum(m, 2).astype(dt),
                                    a_sign=self._a_sign).astype(dt)
            acc = jnp.where(in_tab, acc, jnp.where(n > self.n_max, asy, 0.0))
        else:
            acc = jnp.where(in_tab, acc, 0.0)
        return jnp.where((m < 2) | (n < m), jnp.zeros((), dt), acc)

    def U(self, n, m, a):
        n = jnp.asarray(n)
        m = jnp.asarray(m)
        dt = self.vtab.dtype
        v = self.V(n, m, a)
        safe = jnp.where(v > 0, v, 1.0)
        af = jnp.asarray(a, dt)
        gen = n.astype(dt) - m.astype(dt) * af + 1.0 / safe
        return jnp.where(m == 1, n.astype(dt) - af,
                         jnp.where(v > 0, gen, 0.0))

    def data_curve(self, ns, ts, weights=None):
        """sum_k w_k * log S(n_k, t_k; a_g) for every grid point g.

        The precomputation that turns sample_a density evals into O(1):
        evaluate once per Gibbs step, then any a-interpolation of the
        result equals interpolating the sum of log-S terms (linearity).
        Entries with n<=1 contribute 0 (samplea.c:73-79 skips n<=1).
        Returns (G,) (or (..., G) for batched ns/ts with leading axes).

        Pairs must lie within the grid (t <= m_max, n <= n_max) except for
        the exact identities (t==n contributes 0, t==1 contributes S1);
        out-of-grid NON-identity pairs have no cheap in-graph value, so
        drivers must grow the grid first (ensure_grid /
        required_dims) -- the reference's S_extend-on-query
        (stable.c:963) done preflight.

        When the pair counts ``ns`` are shared across chains (the usual
        Gibbs case: data is fixed, only t varies per chain) and m_max <=
        512, the reduction runs as one one-hot contraction -- (C, P*M) @
        (P*M, G) -- instead of G*C*P gathers (whether it beats the gather
        on the GPU is open: ROADMAP A3).
        """
        ns = jnp.asarray(ns)
        ts = jnp.asarray(ts)
        if ts.ndim >= 2 and ns.ndim == 1 and self.m_max <= 512:
            return self._data_curve_mm(ns, ts, weights)
        return self._data_curve_gather(ns, ts, weights)

    def _data_curve_gather(self, ns, ts, weights=None):
        shape = jnp.broadcast_shapes(ns.shape, ts.shape)
        ns = jnp.broadcast_to(ns, shape)
        ts = jnp.broadcast_to(ts, shape)
        i = jnp.clip(ns - 1, 0, self.n_max - 1)
        j = jnp.clip(ts - 1, 0, self.m_max - 1)
        dt = self.srel.dtype
        vals = (self.s1_hi[:, i] + self.srel[:, i, j] + self.s1_lo[:, i])
        # identities
        vals = jnp.where(ns == ts, jnp.zeros((), dt), vals)
        vals = jnp.where(ts == 1, self.s1_hi[:, i] + self.s1_lo[:, i], vals)
        mask = (ns > 1) & (ts >= 1) & (ts <= ns)
        w = mask.astype(dt) if weights is None else weights * mask
        out = jnp.sum(vals * w, axis=-1)       # (G, ...) summed over pairs
        return jnp.moveaxis(out, 0, -1)        # (..., G)

    def data_curve_sparse(self, ns, ts, weights=None, chunk: int = 65536):
        """Streaming CSR-style data_curve (the ``getval`` capability,
        psample.h:101-115): reduce over the pair axis in fixed-size
        chunks via ``lax.scan`` so sample_a handles D*J >= 10^6 occupied
        pairs without ever materialising a (G, C, P) or (C, P, M)
        intermediate -- peak memory is O(G * C * chunk), work identical
        to the gather route.

        ``ns``: (P,) counts; ``ts``: (P,) or (C, P) tables; the caller
        passes OCCUPIED pairs only (CSR values; zero-padding is free
        because n <= 1 pairs contribute 0, samplea.c:73-79).  Returns
        the same (..., G) curve as data_curve (tested equal in
        tests/test_agrid.py)."""
        ns = jnp.asarray(ns)
        ts = jnp.asarray(ts)
        P = ns.shape[-1]
        nseg = -(-P // chunk)
        pad = nseg * chunk - P
        ns_p = jnp.pad(ns, (0, pad))                     # n=0 -> masked
        lead = ts.shape[:-1]
        ts_p = jnp.pad(ts, ((0, 0),) * len(lead) + ((0, pad),))
        w_p = (None if weights is None
               else jnp.pad(weights, ((0, 0),) * (weights.ndim - 1)
                            + ((0, pad),)))
        ns_s = ns_p.reshape(nseg, chunk)
        ts_s = jnp.moveaxis(ts_p.reshape(lead + (nseg, chunk)), -2, 0)
        xs = (ns_s, ts_s) if w_p is None else (
            ns_s, ts_s, jnp.moveaxis(
                w_p.reshape(lead + (nseg, chunk)), -2, 0))

        def seg(acc, x):
            if w_p is None:
                nseg_, tseg = x
                return acc + self._data_curve_gather(nseg_, tseg), None
            nseg_, tseg, wseg = x
            return acc + self._data_curve_gather(nseg_, tseg, wseg), None

        acc0 = jnp.zeros(lead + (self.g_max,), self.srel.dtype)
        out, _ = jax.lax.scan(seg, acc0, xs)
        return out

    def _data_curve_mm(self, ns, ts, weights=None):
        """Contraction route of data_curve (shared ns): see data_curve
        docstring.

        rows[g, p, m] = S1(n_p) + Srel(n_p, m+1) carries the m==1
        identity for free (Srel(n, 1) = 0); the t==n identity (log S = 0)
        is applied as an explicit mask -- relying on the in-table
        diagonal only covers t == n <= m_max, and clipping would
        otherwise gather Srel(n, m_max) for all-singleton pairs with
        n > m_max.
        """
        dt = self.srel.dtype
        i = jnp.clip(ns - 1, 0, self.n_max - 1)
        rows = (self.s1_hi[:, i, None] + self.srel[:, i, :]
                + self.s1_lo[:, i, None])              # (G, P, M)
        rows = jnp.where(jnp.isfinite(rows), rows, 0.0)
        # t==n contributes exactly 0; excluding it from the contraction
        # also keeps the j-clip below from fabricating a value when
        # t == n > m_max (out-of-grid NON-identity pairs stay the
        # caller's responsibility -- see data_curve docstring).
        mask = (ns[None] > 1) & (ts >= 1) & (ts <= ns[None]) & (ts != ns[None])
        w = mask.astype(dt) if weights is None else weights * mask
        j = jnp.clip(ts - 1, 0, self.m_max - 1)
        oh = jax.nn.one_hot(j, self.m_max, dtype=dt) * w[..., None]
        G = rows.shape[0]
        lhs = oh.reshape(ts.shape[:-1] + (-1,))        # (..., P*M)
        rhs = jnp.moveaxis(rows, 0, -1).reshape(-1, G)  # (P*M, G)
        # HIGHEST: a default-precision f32 product may run in TF32 on the
        # GPU and keep only ~3 digits of each log-S term
        return jax.lax.dot_general(
            lhs, rhs, (((lhs.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=dt, precision=jax.lax.Precision.HIGHEST)

    def curve_at(self, curve, a):
        """Cubic interpolation of a (..., G) curve (from data_curve) at a;
        batched curves pair with batched a along the leading axes."""
        g, t = self._locate(a)
        w = _catmull_weights(t, curve.dtype)
        if curve.ndim == 1:
            return (w[0] * curve[g - 1] + w[1] * curve[g]
                    + w[2] * curve[g + 1] + w[3] * curve[g + 2])
        acc = jnp.zeros(jnp.shape(g), curve.dtype)
        for k in range(4):
            idx = (g - 1 + k)[..., None]
            acc = acc + w[k] * jnp.take_along_axis(curve, idx, axis=-1)[..., 0]
        return acc


def make_grid(n_max: int, m_max: int, g: int = 100,
              a_lo: float = 0.0, a_hi: float = 0.99,
              build_s: bool = True, build_v: bool = True,
              dtype=jnp.float32, mesh=None, max_n: int = 0, max_m: int = 0,
              use_asympt: bool = True, tag: str = "") -> AGridTable:
    """Fill tables for a uniform discount grid.

    The default [0, 0.99] covers the sampler bounds A_MIN=0.01..A_MAX=0.98
    (psample.h:89-90) with a full 4-point stencil inside.

    The fill is ``stirling.fill_rows`` vmapped over the grid.

    ``mesh``: a jax.sharding.Mesh -- the grid axis shards over the mesh's
    first axis and each device fills only its own discounts concurrently
    (the distributed-fill capability of SURVEY.md §5.8; the resulting
    tables stay G-sharded in device memory, and queries' 4-point stencils resolve
    locally because da * stencil << shard width).  ``g`` must divide by
    the mesh axis size.

    ``max_n``/``max_m``: hard bounds (S_make's maxN/maxM); 0 = no growth
    headroom beyond (n_max, m_max).  ``use_asympt``: S_ASYMPT analog for
    out-of-grid queries (default on -- grids are production tables and
    in-graph queries cannot extend them; growth happens via ensure_grid).
    """
    avec = np.linspace(a_lo, a_hi, g)
    s1 = np.stack([stirling.s1_host(float(a), n_max) for a in avec])
    if mesh is None:
        return _finish_grid(avec, s1, n_max, m_max, build_s, build_v,
                            dtype, max_n, max_m, use_asympt, tag)
    return _make_grid_sharded(avec, s1, n_max, m_max, build_s, build_v,
                              dtype, mesh, max_n, max_m, use_asympt, tag)


def _fill_grid(avec, n_max, m_max, dtype, build_s):
    """(vtab, srel) for every discount of ``avec``: fill_rows vmapped."""
    return jax.vmap(lambda a: stirling.fill_rows(
        a, n_max, m_max, dtype=dtype, with_srel=build_s)[:2])(avec)


def _make_grid_sharded(avec, s1, n_max, m_max, build_s, build_v, dtype,
                       mesh, max_n=0, max_m=0, use_asympt=True, tag=""):
    from jax.sharding import NamedSharding, PartitionSpec as P
    axis = mesh.axis_names[0]
    nd = mesh.shape[axis]
    g = len(avec)
    if g % nd:
        raise ValueError(f"grid size {g} not divisible by mesh axis {nd}")
    gshard = NamedSharding(mesh, P(axis))

    def fill_shard(a_shard):
        # runs per device on its local discounts
        v, s = _fill_grid(a_shard, n_max, m_max, dtype, build_s)
        return (v, s) if build_s else (v,)

    a_dev = jax.device_put(jnp.asarray(avec, dtype), gshard)
    out_specs = (P(axis), P(axis)) if build_s else (P(axis),)
    # check_vma=False: the per-shard fill's scan carries are not marked
    # as varying over the mesh axis
    shard_fill = jax.jit(jax.shard_map(fill_shard, mesh=mesh,
                                       in_specs=P(axis),
                                       out_specs=out_specs,
                                       check_vma=False))
    outs = shard_fill(a_dev)
    vtab = outs[0]
    srel = outs[1] if build_s else None
    if np.dtype(dtype) == np.float64:
        s1_hi = jax.device_put(jnp.asarray(s1), gshard)
        s1_lo = jnp.zeros_like(s1_hi)
    else:
        hi = s1.astype(np.float32)
        s1_hi = jax.device_put(jnp.asarray(hi), gshard)
        s1_lo = jax.device_put(
            jnp.asarray((s1 - hi.astype(np.float64)).astype(np.float32)),
            gshard)
    return AGridTable(
        a0=float(avec[0]), da=float(avec[1] - avec[0]), g_max=g,
        n_max=n_max, m_max=m_max, avec=a_dev,
        s1_hi=s1_hi, s1_lo=s1_lo,
        vtab=vtab if build_v else None,
        srel=srel if build_s else None,
        max_n=max_n, max_m=max_m, use_asympt=use_asympt, tag=tag)


def _finish_grid(avec, s1, n_max, m_max, build_s, build_v, dtype,
                 max_n=0, max_m=0, use_asympt=True, tag=""):
    if np.dtype(dtype) == np.float64:
        s1_hi = jnp.asarray(s1)
        s1_lo = jnp.zeros_like(s1_hi)
    else:
        hi = s1.astype(np.float32)
        s1_hi = jnp.asarray(hi)
        s1_lo = jnp.asarray((s1 - hi.astype(np.float64)).astype(np.float32))
    vtab, srel = _fill_grid(jnp.asarray(avec, dtype), n_max, m_max, dtype,
                            build_s)
    return AGridTable(
        a0=float(avec[0]), da=float(avec[1] - avec[0]), g_max=len(avec),
        n_max=n_max, m_max=m_max,
        avec=jnp.asarray(avec, dtype),
        s1_hi=s1_hi, s1_lo=s1_lo,
        vtab=vtab if build_v else None,
        srel=srel if build_s else None,
        max_n=max_n, max_m=max_m, use_asympt=use_asympt, tag=tag)


def _grow_bucket(used: int, want: int) -> int:
    """S_extend's >=10%-or-+50 hysteresis, rounded to jit-friendly
    buckets (stable.c:590-630 semantics, same policy as stirling.ensure)."""
    if want <= used:
        return used
    want = max(want, int(used * 1.1), used + 50)
    k = int(np.floor(np.log2(max(want, 64))))
    for frac in (1.0, 1.25, 1.5, 1.75, 2.0):
        b = int(frac * 2 ** k)
        if b >= want:
            return b
    return want


def ensure_grid(grid: AGridTable, n: int, m: int,
                quit_on_bound: bool = False) -> AGridTable:
    """Growth for grid tables (the S_extend analog, host-level): returns a
    (possibly new) grid covering (n, m) with bucketed dimensions so jit
    caches stay warm.  Refills the whole grid -- the batched fill is fast
    enough that the reference's incremental L-shaped refill isn't worth
    its complexity here.

    Growth clamps at the hard bounds (max_n/max_m, when set): beyond them
    queries fall to the asymptote/-inf conventions, or -- with
    ``quit_on_bound`` (the S_QUITONBOUND policy, stable.h:32-33) -- this
    call raises LibstbError instead of returning a clamped grid."""
    n = int(n) + 1
    m = int(m) + 1
    if quit_on_bound and (n > grid._hard_n() or m > grid._hard_m()):
        from ..utils import yaps
        yaps.quit("a-grid%s: ensure_grid(%d,%d) hit hard bounds (%d,%d) "
                  "(stable.c:915-917)",
                  f" '{grid.tag}'" if grid.tag else "",
                  n, m, grid._hard_n(), grid._hard_m())
    n = min(n, grid._hard_n())
    m = min(m, grid._hard_m())
    if n <= grid.n_max and m <= grid.m_max:
        return grid
    new_n = min(_grow_bucket(grid.n_max, max(n, grid.n_max)), grid._hard_n())
    new_m = min(_grow_bucket(grid.m_max, max(m, grid.m_max)), new_n,
                grid._hard_m())
    avec = np.asarray(grid.avec, np.float64)
    s1 = np.stack([stirling.s1_host(float(a), new_n) for a in avec])
    return _finish_grid(avec, s1, new_n, new_m,
                        grid.srel is not None, grid.vtab is not None,
                        grid.s1_hi.dtype,
                        grid.max_n, grid.max_m, grid.use_asympt, grid.tag)


def required_dims(data_n, t=None):
    """(n, m) the grid must cover for a Gibbs run over category counts
    ``data_n`` (any shape): n = max count + 1 (the t+1 of V queries and
    S_extend's N+1, stable.c:963), m = max table count + 1, where table
    counts are bounded by the counts themselves unless a state ``t`` with
    larger entries is supplied (HPYP levels can exceed per-category data
    counts)."""
    n_req = int(np.asarray(data_n).max()) + 1
    m_req = n_req
    if t is not None:
        m_req = max(m_req, int(np.asarray(t).max()) + 1)
    return n_req, m_req
