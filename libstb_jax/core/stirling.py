"""L1 Stirling-number table engine.

Reproduces the capabilities of the reference Stirling table engine
(``lib/stable.h:62-190``, ``lib/stable.c``) with a different, array-oriented
architecture:

* The reference fills ``log S`` by the log-space recurrence
  ``S^n_m = S^{n-1}_{m-1} + (n-1-m a) S^{n-1}_m`` with a ``logadd`` per cell
  (stable.c:380-387) and keeps a float table + double frontier for precision
  (stable.c:14-22, 389-449).  Tables here are f32 (half the bytes of f64,
  and XLA's f32 ``log``/``exp`` are only ~1e-4 accurate), so we instead
  fill the **ratio table** ``V^n_m = S^n_m / S^n_{m-1}`` by its rational
  recurrence (stable.c:475-482) -- no transcendentals, O(1) magnitudes,
  float-stable
  (the reference's own conclusion, test/precision_test.c:10-13) -- and
  derive the log-S table as a per-row prefix sum::

      log S(n, m) = S1(n) + sum_{j=2..m} log V(n, j)

  This eliminates the N-direction error accumulation of the log recurrence
  entirely: each S row depends only on that row's V values and the exactly
  known ``S1(n) = lgamma(n-a) - lgamma(1-a)`` (stable.h:154-160), which we
  compute host-side in f64 (stored as a two-float hi/lo pair in f32).
  V itself is a recurrence along n: its f32 rounding errors are correlated
  from row to row, so V's relative error grows about linearly in n (worst
  cells 0.2-0.6 n*2^-24 against the long-double oracle; chip_smoke.v_tol).

* Rows depend only on the previous row, so the fill is a ``lax.scan`` over
  ``n`` with fully vectorised M-wide rows (``fill_rows``).

* The reference's mutex-guarded dynamic growth (stable.c:564-815) becomes
  functional, bucketed re-creation: ``ensure()`` returns a (possibly new)
  table whose sizes are rounded up with the same >=10%-or-+50 hysteresis,
  so jit caches stay warm; queries are total functions with the
  ``S_ASYMPT`` asymptote fallback (stable.c:951-953, 1057-1084) applied
  in-graph.

Row/column layout: index ``[i, j]`` holds the value at ``n = i+1``,
``m = j+1`` (dense rectangular, unlike the reference's triangular blocks --
every query is a plain 2-D gather).  Column ``j=0`` of ``V`` holds
+inf (so that ``1/V(n,1) == 0`` keeps the recurrence uniform, mirroring the
boundary handling at stable.c:469,476) and cells with ``m > n`` hold 0,
matching ``S_V``'s out-of-domain convention (stable.c:928).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "StirlingTable",
    "make",
    "remake",
    "ensure",
    "fill_rows",
    "s1_host",
    "s_asympt",
    "v_asympt",
]


# ---------------------------------------------------------------------------
# S1 (first column): log S^n_{1,a} = lgamma(n - a) - lgamma(1 - a)
# ---------------------------------------------------------------------------

def s1_host(a: float, n_max: int) -> np.ndarray:
    """Host-side f64 S1 vector, s1[i] = log S^{i+1}_{1,a} (stable.h:154-160)."""
    from scipy.special import gammaln

    n = np.arange(1, n_max + 1, dtype=np.float64)
    return gammaln(n - a) - gammaln(1.0 - a)


def s1_ingraph(a, n_max: int, dtype=jnp.float32):
    """In-graph S1 for traced ``a`` (used by the rebuild-per-eval oracle
    path of samplea, samplea.c:57-60).  In f32 this inherits XLA's
    lgamma accuracy; the host path is preferred whenever ``a`` is concrete.
    """
    n = jnp.arange(1, n_max + 1, dtype=dtype)
    return jax.lax.lgamma(n - a) - jax.lax.lgamma(jnp.asarray(1.0 - a, dtype))


def _split_hi_lo(x64: np.ndarray):
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _s1_pair(a: float, n_max: int, dtype):
    """Host f64 S1 as the table's (hi, lo) pair: lo is 0 for f64 tables,
    the f32 rounding residue otherwise."""
    s1 = s1_host(a, n_max)
    if np.dtype(dtype) == np.float64:
        return jnp.asarray(s1), jnp.zeros_like(jnp.asarray(s1))
    hi, lo = _split_hi_lo(s1)
    return jnp.asarray(hi), jnp.asarray(lo)


# ---------------------------------------------------------------------------
# Core fill: scan over n of the V-ratio recurrence + per-row log-prefix-sum
# ---------------------------------------------------------------------------

def _v_first_row(m_max: int, dtype):
    """Row n=1: col0=+inf (V(n,1) sentinel), rest 0 (m>n undefined)."""
    row = jnp.zeros((m_max,), dtype)
    return row.at[0].set(jnp.inf)


def _v_step(vrow, n, mvec, a):
    """One row of the V recurrence (stable.c:475-482), vectorised over m.

    vrow[j] = V(n-1, j+1) with the col0=+inf / m>n-1 = 0 invariant; returns
    V(n, .) with the same invariant (see module docstring for why the
    boundary cells self-maintain without masks).
    """
    nm1 = (n - 1).astype(vrow.dtype) if hasattr(n, "astype") else vrow.dtype.type(n - 1)
    shift = jnp.concatenate([jnp.full((1,), jnp.inf, vrow.dtype), vrow[:-1]])
    numer = 1.0 + (nm1 - mvec * a) * vrow
    denom = 1.0 / shift + (nm1 - (mvec - 1.0) * a)
    return numer / denom


@functools.partial(jax.jit, static_argnames=("n_max", "m_max", "dtype", "with_srel", "n_start"))
def fill_rows(a, n_max: int, m_max: int, dtype=jnp.float32, with_srel: bool = True,
              v_start: Optional[jax.Array] = None, n_start: int = 1):
    """Fill V (and Srel) rows for n = n_start..n_max.

    Returns (V, Srel, v_last) where V[i] is the ratio row for n = n_start+i,
    Srel[i, j] = log S(n, j+1) - S1(n)  (Srel[:, 0] == 0), and v_last is the
    final ratio row -- the functional analog of the reference's extension
    frontier (stable.c:82-90), used to resume the fill for N-growth
    (S_remake_part's startN path, stable.c:315-320).
    """
    a = jnp.asarray(a, dtype)
    mvec = jnp.arange(1, m_max + 1, dtype=dtype)
    if v_start is None:
        v0 = _v_first_row(m_max, dtype)
    else:
        v0 = v_start.astype(dtype)

    def step(vrow, n):
        vnew = _v_step(vrow, n, mvec, a)
        if with_srel:
            logv = jnp.where(mvec > 1.0, jnp.log(vnew), 0.0)
            srel = jnp.cumsum(logv)
            return vnew, (vnew, srel)
        return vnew, (vnew,)

    ns = jnp.arange(n_start + 1, n_max + 1, dtype=dtype)
    v_last, ys = jax.lax.scan(step, v0, ns)
    vrows = jnp.concatenate([v0[None], ys[0]], axis=0)
    if with_srel:
        srel0 = jnp.where(mvec > 1.0, -jnp.inf, 0.0).astype(dtype)[None]
        if v_start is not None:
            # resumed fill: recompute the start row's srel from v_start
            logv0 = jnp.where(mvec > 1.0, jnp.log(v0), 0.0)
            srel0 = jnp.cumsum(logv0)[None]
        srel = jnp.concatenate([srel0, ys[1]], axis=0)
        return vrows, srel, v_last
    return vrows, None, v_last


# ---------------------------------------------------------------------------
# Asymptotes (stable.c:1057-1084 Hutter / Hwang; stable.c:905-912 for V)
# ---------------------------------------------------------------------------

def s_asympt(a, lga1, n, m, a_sign: str = "any"):
    """log S^n_{m,a} asymptote for n beyond table bounds.

    a>0: Hutter's  Gamma(n) / (Gamma(1-a) Gamma(m) a^{m-1} n^a) with the
    (m-1)log(1-n^-a) refinement (stable.c:1066-1083); a==0: Hwang 2001
    (stable.c:1059-1065).  ``lga1`` = lgamma(1-a) precomputed.
    Inputs n, m may be arrays (float).

    ``a_sign``: "pos"/"zero" statically selects the branch when the sign
    of ``a`` is known at trace time (tables store it) -- the unused
    branch otherwise costs two vectorised lgammas per query element,
    which dominated the in-jit sweep hot path.
    """
    n = jnp.asarray(n, jnp.result_type(float))
    m = jnp.asarray(m, n.dtype)
    a = jnp.asarray(a, n.dtype)
    ln = jnp.log(n)
    if a_sign != "pos":
        # a == 0 (Hwang)
        hwang = (jax.lax.lgamma(n) + (m - 1.0) * jnp.log(ln)
                 - jax.lax.lgamma(m) - jax.lax.lgamma(1.0 + (m - 1.0) / ln))
        if a_sign == "zero":
            return hwang
    # a > 0 (Hutter)
    safe_a = jnp.where(a > 0, a, 1.0) if a_sign != "pos" else a
    npow = jnp.exp(-safe_a * ln)
    base = (jax.lax.lgamma(n) - lga1 - jax.lax.lgamma(m)
            - (m - 1.0) * jnp.log(safe_a) - safe_a * ln)
    small = npow < 1e-5
    corr = jnp.where(
        small,
        -(m - 1.0) * npow * (1.0 + npow * (0.5 + npow / 3.0)),
        (m - 1.0) * jnp.log1p(-jnp.where(small, 0.0, npow)),
    )
    if a_sign == "pos":
        return base + corr
    return jnp.where(a > 0, base + corr, hwang)


def v_asympt(a, n, m, a_sign: str = "any"):
    """V ratio asymptote for n > maxN (stable.c:905-912); ``a_sign`` as
    in s_asympt."""
    n = jnp.asarray(n, jnp.result_type(float))
    m = jnp.asarray(m, n.dtype)
    a = jnp.asarray(a, n.dtype)
    if a_sign == "pos":
        return (1.0 - jnp.exp(-a * jnp.log(n))) / a / (m - 1.0)
    ln = jnp.log(n)
    zero = ln / (m - 1.0) * jnp.exp(
        jax.lax.lgamma(1.0 + (m - 2.0) / ln) - jax.lax.lgamma(1.0 + (m - 1.0) / ln))
    if a_sign == "zero":
        return zero
    safe_a = jnp.where(a > 0, a, 1.0)
    pos = (1.0 - jnp.exp(-safe_a * jnp.log(n))) / safe_a / (m - 1.0)
    return jnp.where(a > 0, pos, zero)


# ---------------------------------------------------------------------------
# The table pytree
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StirlingTable:
    """Immutable Stirling table pytree (the stable_t analog, stable.h:62-113).

    ``s1_hi + s1_lo`` reconstructs the f64 S1 on f32 backends (the
    capability of the reference's double frontier, stable.h:82-90, applied
    to the only column whose absolute magnitude matters).  ``vtab`` and
    ``srel`` are natural (N, M) row-major arrays.
    """
    a: jax.Array               # scalar, the discount
    lga1: jax.Array            # scalar, lgamma(1-a)
    s1_hi: jax.Array           # (N,)
    s1_lo: jax.Array           # (N,)
    vtab: Optional[jax.Array]  # (N, M) ratio table, or None
    srel: Optional[jax.Array]  # (N, M) log S - S1, or None
    n_max: int = dataclasses.field(metadata=dict(static=True))
    m_max: int = dataclasses.field(metadata=dict(static=True))
    max_n: int = dataclasses.field(metadata=dict(static=True))   # hard bound (maxN)
    max_m: int = dataclasses.field(metadata=dict(static=True))   # hard bound (maxM)
    use_asympt: bool = dataclasses.field(metadata=dict(static=True))
    # debugging tag carried into reports and error messages (S_tag,
    # stable.h:137-138; used at stable.c:105-108, 915-917 to identify
    # which of several tables hit a bound)
    tag: str = dataclasses.field(default="", metadata=dict(static=True))
    # sign of the (concrete-at-make) discount, so in-jit queries pick the
    # Hutter vs Hwang asymptote branch statically instead of evaluating
    # both (None = unknown, evaluate both)
    a_pos: Optional[bool] = dataclasses.field(default=None,
                                              metadata=dict(static=True))

    @property
    def _a_sign(self) -> str:
        if self.a_pos is None:
            return "any"
        return "pos" if self.a_pos else "zero"

    # -- queries ------------------------------------------------------------
    def S1(self, n):
        """log S^n_{1,a} (S_S1, stable.c:822-873). n may be an int array."""
        n = jnp.asarray(n)
        i = jnp.clip(n - 1, 0, self.n_max - 1)
        in_tab = (n >= 1) & (n <= self.n_max)
        val = (self.s1_hi[i] + self.s1_lo[i]).astype(self.s1_hi.dtype)
        dt = val.dtype
        # beyond table: exact formula via lgamma (cheap, vectorised)
        beyond = jax.lax.lgamma(n.astype(dt) - self.a.astype(dt)) - self.lga1.astype(dt)
        out = jnp.where(in_tab, val, beyond)
        return jnp.where(n >= 1, out, -jnp.inf)

    def S(self, n, m):
        """log S^n_{m,a} (S_S, stable.c:941-974) as a total function.

        Identities: n==m -> 0, m==1 -> S1, m==0 or n<m -> -inf.  Beyond
        (max_n, max_m) returns the asymptote when ``use_asympt`` else -inf
        (the S_QUITONBOUND death is a host-level policy, see ensure()).
        """
        n = jnp.asarray(n)
        m = jnp.asarray(m)
        dt = self.s1_hi.dtype
        i = jnp.clip(n - 1, 0, self.n_max - 1)
        j = jnp.clip(m - 1, 0, self.m_max - 1)
        in_tab = (n >= 1) & (n <= self.n_max) & (m >= 1) & (m <= self.m_max)
        if self.srel is not None:
            body = (self.s1_hi[i] + self.srel[i, j]) + self.s1_lo[i]
        else:
            body = jnp.full(jnp.broadcast_shapes(n.shape, m.shape), -jnp.inf, dt)
        if self.use_asympt:
            asy = s_asympt(self.a.astype(dt), self.lga1.astype(dt),
                           jnp.maximum(n, 1).astype(dt), jnp.maximum(m, 1).astype(dt),
                           a_sign=self._a_sign)
            body = jnp.where(in_tab, body, asy.astype(dt))
        else:
            body = jnp.where(in_tab, body, -jnp.inf)
        body = jnp.where(n == m, jnp.zeros((), dt), body)
        body = jnp.where(m == 1, self.S1(n).astype(dt), body)
        return jnp.where((m < 1) | (n < m), -jnp.inf, body)

    def Srel(self, n, m):
        """log S^n_{m,a} - log S^n_{1,a}: the cancellation-free form for
        within-row differences (what the CT/CTW samplers consume,
        test/check.c:877-931)."""
        n = jnp.asarray(n)
        m = jnp.asarray(m)
        dt = self.s1_hi.dtype
        i = jnp.clip(n - 1, 0, self.n_max - 1)
        j = jnp.clip(m - 1, 0, self.m_max - 1)
        body = self.srel[i, j]
        body = jnp.where(n == m, -(self.s1_hi[i] + self.s1_lo[i]).astype(dt), body)
        body = jnp.where(m == 1, jnp.zeros((), dt), body)
        return jnp.where((m < 1) | (n < m), -jnp.inf, body)

    def V(self, n, m):
        """V^n_{m,a} = S^n_m / S^n_{m-1} (S_V, stable.c:900-939), m>=2.

        Returns 0 for illegal/out-of-bound inputs (the reference
        convention) unless beyond max_n with asymptote enabled."""
        n = jnp.asarray(n)
        m = jnp.asarray(m)
        dt = self.vtab.dtype if self.vtab is not None else self.s1_hi.dtype
        i = jnp.clip(n - 1, 0, self.n_max - 1)
        j = jnp.clip(m - 1, 0, self.m_max - 1)
        if self.vtab is not None:
            body = self.vtab[i, j]
        else:
            body = jnp.zeros(jnp.broadcast_shapes(n.shape, m.shape), dt)
        in_tab = (n <= self.n_max) & (m <= self.m_max)
        if self.use_asympt:
            asy = v_asympt(self.a.astype(dt), jnp.maximum(n, 2).astype(dt),
                           jnp.maximum(m, 2).astype(dt),
                           a_sign=self._a_sign).astype(dt)
            body = jnp.where(in_tab, body, jnp.where(n > self.max_n, asy, 0.0))
        else:
            body = jnp.where(in_tab, body, 0.0)
        return jnp.where((m < 2) | (n < m), jnp.zeros((), dt), body)

    def V_rows(self, n, m_sel: int):
        """V(n[p], m) for m = 1..m_sel as a dense (P, m_sel) block.

        Samplers whose Stirling ROW is fixed per lane (the pair-major TI
        sweep: n = pair count, only m moves) extract their rows ONCE per
        sweep by a one-hot contraction and then select within rows with a
        fused compare-reduce, instead of issuing a (chains x pairs)
        gather every Gibbs round (whether this beats the gather on the
        GPU is open: ROADMAP A3).

        Requires n <= n_max and m_sel <= m_max (callers gate on the
        static host-side counts).
        """
        if self.vtab is None:
            raise ValueError("V_rows needs a vtab")
        n = jnp.asarray(n)
        dt = self.vtab.dtype
        oh = jax.nn.one_hot(n - 1, self.n_max, dtype=dt)       # (P, N)
        # precision=HIGHEST: a default-precision f32 product may run in
        # TF32 on the GPU, which would make this extraction diverge from
        # the point-gather path it must match exactly (one-hot rows are
        # exact either way; the TABLE values are not)
        hp = jax.lax.Precision.HIGHEST
        rows = jax.lax.dot_general(
            oh, self.vtab[:, :m_sel], (((1,), (0,)), ((), ())),
            preferred_element_type=dt, precision=hp)           # (P, m_sel)
        mvec = jnp.arange(1, m_sel + 1)
        ok = (mvec[None, :] >= 2) & (mvec[None, :] <= n[:, None])
        return jnp.where(ok, rows, 0.0)

    def Srel_rows(self, n, m_sel: int):
        """Srel(n[p], m) for m = 1..m_sel as a dense (P, m_sel) block
        (the V_rows analog for the CT/CTW weight kernels).

        The raw srel table holds -inf above the diagonal, which would
        NaN-poison a one-hot contraction (0 * -inf), so the slice is
        sanitised to 0 there first and the -inf / diagonal / m==1
        identities are re-applied in row space -- including the EXACT
        diagonal Srel(n, n) = -S1(n) that the point query enforces.
        """
        if self.srel is None:
            raise ValueError("Srel_rows needs srel")
        n = jnp.asarray(n)
        dt = self.srel.dtype
        oh = jax.nn.one_hot(n - 1, self.n_max, dtype=dt)       # (P, N)
        sl = self.srel[:, :m_sel]
        clean = jnp.where(jnp.isfinite(sl), sl, 0.0)
        rows = jax.lax.dot_general(
            oh, clean, (((1,), (0,)), ((), ())),
            preferred_element_type=dt,
            precision=jax.lax.Precision.HIGHEST)               # see V_rows
        i = jnp.clip(n - 1, 0, self.n_max - 1)
        s1 = (self.s1_hi[i] + self.s1_lo[i]).astype(dt)
        mvec = jnp.arange(1, m_sel + 1)
        rows = jnp.where(mvec[None, :] == n[:, None], -s1[:, None], rows)
        rows = jnp.where(mvec[None, :] == 1, jnp.zeros((), dt), rows)
        # n < m mask LAST (as Srel() orders it): for n = 0 every column
        # is out of domain, including m = 1
        return jnp.where(mvec[None, :] > n[:, None], -jnp.inf, rows)

    def U(self, n, m):
        """U^n_{m,a} = S^{n+1}_m / S^n_m  (S_U, stable.c:875-883)."""
        n = jnp.asarray(n)
        m = jnp.asarray(m)
        dt = self.vtab.dtype if self.vtab is not None else self.s1_hi.dtype
        v = self.V(n, m)
        safe = jnp.where(v > 0, v, 1.0)
        gen = n.astype(dt) - m.astype(dt) * self.a.astype(dt) + 1.0 / safe
        return jnp.where(m == 1, n.astype(dt) - self.a.astype(dt),
                         jnp.where(v > 0, gen, 0.0))

    def UV(self, n, m):
        """U*V with the m==n+1 / m==n identities (S_UV, stable.c:885-897)."""
        n = jnp.asarray(n)
        m = jnp.asarray(m)
        dt = self.vtab.dtype if self.vtab is not None else self.s1_hi.dtype
        v = self.V(n, m)
        gen = (n.astype(dt) - m.astype(dt) * self.a.astype(dt)) * v + 1.0
        out = jnp.where(m == n + 1, jnp.ones((), dt), gen)
        out = jnp.where(m == n, (n.astype(dt) + 1.0) / (n.astype(dt) - 1.0), out)
        return jnp.where(m == 1, -jnp.inf, out)

    def report(self) -> str:
        """One-line stats string (S_report, stable.c:1025-1055)."""
        nbytes = sum(x.size * x.dtype.itemsize
                     for x in (self.vtab, self.srel, self.s1_hi, self.s1_lo)
                     if x is not None)
        name = f" '{self.tag}'" if self.tag else ""
        return (f"S-table{name}: a={float(self.a):f}, "
                f"N={self.n_max}/{self.max_n}, "
                f"M={self.m_max}/{self.max_m}, "
                f"{'+S' if self.srel is not None else ''}"
                f"{'+U/V' if self.vtab is not None else ''} "
                f"{np.dtype(self.s1_hi.dtype).name} mem={nbytes // 1024}k")


# ---------------------------------------------------------------------------
# Construction / growth (S_make / S_remake / S_extend semantics)
# ---------------------------------------------------------------------------

def _norm_dims(init_n, init_m, max_n, max_m):
    """Dimension clamping identical to S_make (stable.c:118-129)."""
    max_m = max(max_m, 10)
    max_n = max(max_n, max_m)
    init_m = max(init_m, 10)
    init_n = max(init_n, init_m)
    init_n = min(init_n, max_n)
    init_m = min(init_m, max_m, init_n)
    return init_n, init_m, max_n, max_m


def make(init_n: int, init_m: int, max_n: int, max_m: int, a: float,
         build_s: bool = True, build_v: bool = True,
         use_asympt: bool = False, dtype=jnp.float32,
         tag: str = "") -> StirlingTable:
    """Build a table (S_make, stable.c:110-312).  ``a`` must be concrete
    (host float) so S1 is computed in f64 -- the samplers never need a
    traced-``a`` table thanks to the a-grid design (see agrid.py).  The
    rows are filled on the device by ``fill_rows``."""
    init_n, init_m, max_n, max_m = _norm_dims(init_n, init_m, max_n, max_m)
    if not (build_s or build_v):
        raise ValueError(f"make({tag or 'S-table'}): need at least one of "
                         "build_s/build_v (stable.c:131, 105-108)")
    from scipy.special import gammaln

    a = float(a)
    vtab, srel, _ = fill_rows(a, init_n, init_m, dtype=dtype,
                              with_srel=build_s)
    # S1 after dispatching the device fill: dispatch is async, so the
    # host f64 work overlaps the fill
    s1_hi, s1_lo = _s1_pair(a, init_n, dtype)
    return StirlingTable(
        a=jnp.asarray(a, dtype), lga1=jnp.asarray(float(gammaln(1.0 - a)), dtype),
        s1_hi=s1_hi, s1_lo=s1_lo,
        vtab=vtab if build_v else None,
        srel=srel if build_s else None,
        n_max=init_n, m_max=init_m, max_n=max_n, max_m=max_m,
        use_asympt=use_asympt, tag=tag, a_pos=(a > 0.0))


def remake(table: StirlingTable, a: float) -> StirlingTable:
    """Refill for a new discount (S_remake, stable.c:549-554)."""
    return make(table.n_max, table.m_max, table.max_n, table.max_m, a,
                build_s=table.srel is not None, build_v=table.vtab is not None,
                use_asympt=table.use_asympt,
                dtype=table.s1_hi.dtype, tag=table.tag)


def _grow_dim(used: int, want: int, hard: int) -> int:
    """Growth hysteresis of S_extend (stable.c:590-630): at least +10% and
    +50, then rounded up to a power-of-two-ish bucket so jit caches hit."""
    want = max(want, used)
    if want > used:
        want = max(want, int(used * 1.1), used + 50)
    want = min(want, hard)
    # bucket: next value of form {1,1.25,1.5,1.75} * 2^k to bound recompiles
    if want > used:
        k = int(np.floor(np.log2(max(want, 64))))
        for frac in (1.0, 1.25, 1.5, 1.75, 2.0):
            b = int(frac * 2 ** k)
            if b >= want:
                return min(b, hard)
    return want


def ensure(table: StirlingTable, n: int, m: int,
           quit_on_bound: bool = False) -> StirlingTable:
    """Host-level growth (S_extend semantics, stable.c:564-815): returns a
    table covering (n, m), reusing the existing fill as the resume frontier
    for pure N-growth.  Call between jit steps; inside jit the queries fall
    back to the asymptote / -inf just as the reference's bound checks do.

    ``quit_on_bound``: the S_QUITONBOUND policy (stable.h:32-33) -- die
    with the table's tag in the message (stable.c:915-917) instead of
    clamping at the hard bounds.  Unlike the reference, which dies at
    QUERY time inside S_V/S_S (stable.c:915-917), the policy here fires
    only at this host-side ensure() call: in-graph queries past
    (max_n, max_m) cannot raise, so they fall back to the asymptote /
    -inf / 0 conventions regardless of the flag."""
    if quit_on_bound and (int(n) + 1 > table.max_n
                          or int(m) + 1 > table.max_m):
        from ..utils import yaps
        yaps.quit("S-table%s: ensure(%d,%d) hit hard bounds (%d,%d) "
                  "(stable.c:915-917)",
                  f" '{table.tag}'" if table.tag else "",
                  int(n), int(m), table.max_n, table.max_m)
    n = min(int(n) + 1, table.max_n)
    m = min(int(m) + 1, table.max_m)
    if n <= table.n_max and m <= table.m_max:
        return table
    new_n = _grow_dim(table.n_max, max(n, table.n_max), table.max_n)
    new_m = _grow_dim(table.m_max, max(m, table.m_max), table.max_m)
    new_m = min(new_m, new_n)
    a = float(table.a)
    dtype = table.s1_hi.dtype
    if (new_m == table.m_max and new_n > table.n_max
            and table.vtab is not None):
        # resume from the last filled row (the frontier path,
        # stable.c:357-368): refill only rows n_max..new_n
        v_last = table.vtab[-1]
        vext, srelext, _ = fill_rows(a, new_n, new_m, dtype=dtype,
                                     with_srel=table.srel is not None,
                                     v_start=v_last, n_start=table.n_max)
        vtab = jnp.concatenate([table.vtab, vext[1:]], axis=0)
        srel = (jnp.concatenate([table.srel, srelext[1:]], axis=0)
                if table.srel is not None else None)
        s1_hi, s1_lo = _s1_pair(a, new_n, dtype)
        return dataclasses.replace(
            table, s1_hi=s1_hi, s1_lo=s1_lo, vtab=vtab, srel=srel, n_max=new_n)
    # M growth (or mixed): full refill at the new size
    return make(new_n, new_m, table.max_n, table.max_m, a,
                build_s=table.srel is not None, build_v=table.vtab is not None,
                use_asympt=table.use_asympt, dtype=dtype, tag=table.tag)
