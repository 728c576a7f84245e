"""L4 Pitman-Yor process models: data generation and Gibbs sweeps.

Reproduces the workloads of the reference test programs -- the canonical
Gibbs demo (test/demo.c) and the five-sampler comparison suite
(test/check.c) -- as batched, jittable kernels:

* ``crp_generate`` -- CRP simulation for synthetic counts
  (demo.c:284-311 / check.c data gen), host-side numpy like the
  reference's setup phase.
* ``ti_sweep``   -- table-indicator sampler (demo.c:405-434,
  check.c:843-867): scan over data items, chains vectorised.
* ``ct_sweep``   -- collapsed-table sampler (check.c:868-904): the
  full conditional over t is evaluated as one masked log-categorical per
  category (the early-stopping heuristic of the reference is unnecessary
  when the whole range is a single vector op).
* ``ctw_sweep``  -- windowed collapsed sampler (check.c:905-943) via a
  window mask on the same conditional.

Chains are the leading axis everywhere; each chain may carry its own
(a, b).  Stirling queries go through an AGridTable (per-chain discount,
no rebuilds) or a fixed-a StirlingTable.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..core import agrid, stirling
from ..utils import yaps

_warned_cat_mode = False

__all__ = ["crp_generate", "base_distribution", "init_state", "init_hsa",
           "ti_sweep", "ti_schedule", "ti_sweep_blocked", "ti_pair_layout",
           "ti_sweep_pairs", "ti_sweep_pairs_state", "ti_pair_stages",
           "ti_sweep_pairs_staged", "ti_pair_m_sel", "ct_sweep", "ctw_m_sel",
           "init_hsa_pairs", "hsa_sweep_pairs", "hsa_sweep_pairs_staged",
           "ctw_sweep", "ctw_sweep_rel", "hsa_sweep", "PYPData"]

Table = Union[agrid.AGridTable, stirling.StirlingTable]


class PYPData(NamedTuple):
    """Fixed data for a J-group PYP workload (demo.c globals analog)."""
    data_cat: np.ndarray   # (L,) item categories, concatenated groups
    data_grp: np.ndarray   # (L,) item group index
    first: np.ndarray      # (L,) True if item is the group-category first
    n: np.ndarray          # (J, D) category counts
    N: np.ndarray          # (J,) totals
    H: np.ndarray          # (D,) base distribution


def _vq(tab: Table, n, m, a):
    if isinstance(tab, agrid.AGridTable):
        return tab.V(n, m, a)
    return tab.V(n, m)


def _srelq(tab: Table, n, m, a):
    if isinstance(tab, agrid.AGridTable):
        return tab.Srel(n, m, a)
    return tab.Srel(n, m)


def base_distribution(kind: str, dim: int, b: float = 1.0,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """The 4 base-distribution types of check.c (check.c:88-89, 546-576):
    uniform, linear ramp (H_i prop. to D-i), slow linear ramp
    (prop. to 1.5D-i), and a truncated stick-breaking draw with
    Beta(1, b) sticks ("dirichlet")."""
    kind = kind.lower()
    if kind == "uniform":
        H = np.ones(dim)
    elif kind == "linear":
        H = (dim - np.arange(dim)).astype(np.float64)
    elif kind == "slowlinear":
        H = 1.5 * dim - np.arange(dim)
    elif kind == "dirichlet":
        if rng is None:
            rng = np.random.default_rng(0)
        sticks = rng.beta(1.0, b, size=dim)
        left = np.concatenate([[1.0], np.cumprod(1.0 - sticks[:-1])])
        H = left * sticks
        H[-1] += left[-1] * (1.0 - sticks[-1])
    else:
        raise ValueError(f"unknown base type {kind}")
    return H / H.sum()


def crp_generate(seed: int, n_groups: int, dim: int, n_per_group: int,
                 a: float, b: float, H: Optional[np.ndarray] = None) -> PYPData:
    """CRP simulation (demo.c:284-311): sequential seating, counts only."""
    rng = np.random.default_rng(seed)
    if H is None:
        H = np.full(dim, 1.0 / dim)
    cats, grps, firsts = [], [], []
    n = np.zeros((n_groups, dim), np.int32)
    for j in range(n_groups):
        t = np.zeros(dim, np.int32)
        T = 0
        seen = np.zeros(dim, bool)
        for c in range(n_per_group):
            if c == 0:
                i = rng.choice(dim, p=H)
                t[i] += 1
                T += 1
            else:
                val = (c + b) * rng.random() - (T * a + b)
                if val <= 0:
                    i = rng.choice(dim, p=H)
                    t[i] += 1
                    T += 1
                else:
                    for i in range(dim):
                        val -= n[j, i] - t[i] * a
                        if val < 0:
                            break
            n[j, i] += 1
            cats.append(i)
            grps.append(j)
            firsts.append(not seen[i])
            seen[i] = True
    return PYPData(np.asarray(cats, np.int32), np.asarray(grps, np.int32),
                   np.asarray(firsts), n, n.sum(axis=1).astype(np.int32),
                   np.asarray(H, np.float64))


def from_counts(n: np.ndarray, H: Optional[np.ndarray] = None) -> PYPData:
    """Build a PYPData from given category counts (for oracle comparisons
    against the reference binary, which prints its n[] vector)."""
    n = np.atleast_2d(np.asarray(n, np.int32))
    J, D = n.shape
    cats, grps, firsts = [], [], []
    for j in range(J):
        for i in range(D):
            for c in range(n[j, i]):
                cats.append(i); grps.append(j); firsts.append(c == 0)
    if H is None:
        H = np.full(D, 1.0 / D)
    return PYPData(np.asarray(cats, np.int32), np.asarray(grps, np.int32),
                   np.asarray(firsts), n, n.sum(axis=1).astype(np.int32),
                   np.asarray(H, np.float64))


def init_state(data: PYPData, chains: int):
    """One table per occupied category (demo.c:391-403)."""
    t0 = (data.n > 0).astype(np.int32)
    t = jnp.broadcast_to(jnp.asarray(t0), (chains,) + t0.shape)
    T = jnp.broadcast_to(jnp.asarray(t0.sum(axis=1)), (chains, t0.shape[0]))
    return t, T


@functools.partial(jax.jit, static_argnames=("skip_first", "legacy_odds"))
def ti_sweep(key, t, T, a, b, tab: Table, data: PYPData,
             skip_first: bool = True, legacy_odds: bool = False):
    """Table-indicator Gibbs sweep (demo.c:405-434, check.c:843-867).

    t: (C, J, D) int32; T: (C, J) int32; a, b: (C,).

    Derivation of the acceptance odds: with the uniform-configuration
    augmentation p(t, config) = p(t)/C(n-1, t-1) (the first occurrence's
    indicator is forced to 1, hence check.c's c==f[i] guard), the per-item
    Gibbs odds for re-adding an indicator after removal are

        H_i (b + T a) V(n, t+1) * t / (n - t).

    The REFERENCE uses t/(n-t+1) instead (demo.c:427, check.c:861), which
    is measurably biased: running the reference's own check program with
    identical data gives E[T]=10.87 for TI vs 12.06 for both CT and SA
    (SA is the exact explicit-seating sampler).  We default to the exact
    odds; ``legacy_odds=True`` reproduces the reference's kernel.
    ``skip_first=False`` additionally reproduces demo.c's variant that
    resamples first occurrences as if they were free (a second small
    bias).
    """
    dt = a.dtype
    cats = jnp.asarray(data.data_cat)
    grps = jnp.asarray(data.data_grp)
    firsts = jnp.asarray(data.first)
    n = jnp.asarray(data.n)
    H = jnp.asarray(data.H, dt)

    def item(carry, inp):
        t, T, key = carry
        i, j, is_first = inp
        key, k1, k2 = jax.random.split(key, 3)
        ni = n[j, i]
        skip = (ni <= 1) | (is_first if skip_first else False)
        ti = t[:, j, i]
        Tj = T[:, j]
        u1 = jax.random.uniform(k1, ti.shape, dt)
        nif = ni.astype(dt)
        dec = (ti > 1) & ((nif - 1.0) * u1 < (ti - 1).astype(dt)) & ~skip
        ti = ti - dec
        Tj = Tj - dec
        # acceptance odds (see docstring; demo.c:427-428 for legacy form)
        v = _vq(tab, ni, ti + 1, a)
        denom = (nif - ti.astype(dt) + 1.0) if legacy_odds else jnp.maximum(
            nif - ti.astype(dt), 1.0)
        one = (H[i] * (b + Tj.astype(dt) * a) * ti.astype(dt) / denom * v)
        u2 = jax.random.uniform(k2, ti.shape, dt)
        inc = (u2 < one / (one + 1.0)) & ~skip & (ti < ni)
        ti = ti + inc
        Tj = Tj + inc
        t = t.at[:, j, i].set(ti)
        T = T.at[:, j].set(Tj)
        return (t, T, key), None

    (t, T, _), _ = jax.lax.scan(item, (t, T, key), (cats, grps, firsts))
    return t, T


def ti_schedule(data: PYPData, mode: str = "group") -> np.ndarray:
    """Item schedule (S, W) of item indices (-1 = pad) for the parallel
    TI sweep.

    mode="group": step s holds the s-th item of every group -- an EXACT
    reordering of the sequential sweep (groups are independent
    restaurants, check.c's outer loop is per-group), W = J, S = max group
    size.  mode="cat": step s holds the s-th occurrence of every (group,
    category) pair -- W = #occupied pairs, S = max category count; within
    a step the (b + T a) factor reads the block-start group total (see
    ti_sweep_blocked).  Because of that lag, cat mode's stationary
    distribution is only APPROXIMATELY the posterior: it is a throughput
    kernel, never the default anywhere correctness is asserted (acceptance
    gates and the driver use the exact sweeps), and selecting it warns
    once.
    """
    grp = np.asarray(data.data_grp)
    cat = np.asarray(data.data_cat)
    L = grp.shape[0]
    if mode == "group":
        keys = grp.astype(np.int64)
    elif mode == "cat":
        global _warned_cat_mode
        if not _warned_cat_mode:
            _warned_cat_mode = True
            yaps.message(
                "ti_schedule(mode='cat'): within-step siblings read the "
                "block-start group total T -- an approximate kernel; do "
                "not use for acceptance runs (use mode='group' or "
                "ti_sweep)")
        D = data.n.shape[1]
        pair = grp.astype(np.int64) * D + cat
        uniq, keys = np.unique(pair, return_inverse=True)
    else:
        raise ValueError(f"unknown schedule mode {mode}")
    W = int(keys.max()) + 1
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=W)
    S = int(counts.max())
    sched = np.full((S, W), -1, np.int32)
    pos = 0
    for w in range(W):
        c = counts[w]
        sched[:c, w] = order[pos:pos + c]
        pos += c
    return sched


@functools.partial(jax.jit, static_argnames=("skip_first", "legacy_odds"))
def _ti_blocked_jit(key, t, T, a, b, tab: Table, data: PYPData, sched,
                    skip_first: bool, legacy_odds: bool):
    dt = a.dtype
    cats = jnp.asarray(data.data_cat)
    grps = jnp.asarray(data.data_grp)
    firsts = jnp.asarray(data.first)
    n = jnp.asarray(data.n)
    H = jnp.asarray(data.H, dt)
    C = t.shape[0]

    def step(carry, idx):
        t, T, key = carry                       # idx: (W,)
        key, k1, k2 = jax.random.split(key, 3)
        valid = idx >= 0
        safe = jnp.maximum(idx, 0)
        i = cats[safe]                          # (W,)
        j = grps[safe]
        is_first = firsts[safe]
        ni = n[j, i]
        skip = (~valid) | (ni <= 1) | (is_first if skip_first else False)
        ti = t[:, j, i]                         # (C, W)
        Tj = T[:, j]                            # block-start totals
        u1 = jax.random.uniform(k1, ti.shape, dt)
        nif = ni.astype(dt)[None]
        dec = (ti > 1) & ((nif - 1.0) * u1 < (ti - 1).astype(dt)) \
            & ~skip[None]
        ti2 = ti - dec
        Tj2 = Tj - dec
        v = _vq(tab, ni[None], ti2 + 1, a[:, None])
        denom = (nif - ti2.astype(dt) + 1.0) if legacy_odds else jnp.maximum(
            nif - ti2.astype(dt), 1.0)
        one = (H[i][None] * (b[:, None] + Tj2.astype(dt) * a[:, None])
               * ti2.astype(dt) / denom * v)
        u2 = jax.random.uniform(k2, ti.shape, dt)
        inc = (u2 < one / (one + 1.0)) & ~skip[None] & (ti2 < ni[None])
        ti3 = ti2 + inc
        # scatter: (j, i) pairs are distinct within a step by schedule
        # construction, so t adds never collide; T adds may repeat j
        # (cat mode) and accumulate
        t = t.at[:, j, i].add((ti3 - ti).astype(t.dtype))
        T = T.at[:, j].add((ti3 - ti).astype(T.dtype))
        return (t, T, key), None

    (t, T, _), _ = jax.lax.scan(step, (t, T, key), sched)
    return t, T


def ti_sweep_blocked(key, t, T, a, b, tab: Table, data: PYPData,
                     sched: Optional[np.ndarray] = None,
                     mode: str = "group", skip_first: bool = True,
                     legacy_odds: bool = False):
    """Parallel table-indicator sweep over an item schedule.

    mode="group" processes one item of every group per sequential step --
    an exact reordering of ti_sweep (the per-group chains compose the
    same conditional updates in the same per-group order), cutting the
    scan length from L items to max-group-size.  mode="cat" additionally
    parallelises within groups over categories: per step, each occupied
    (group, category) pair updates one indicator using the group total T
    read at block start.  The t bookkeeping stays exact (pairs are
    distinct); only the (b + T a) factor lags by at most the within-step
    sibling updates, a bias that vanishes as T grows (tested against the
    sequential sweep in tests/test_models.py).

    Pass a precomputed ``sched`` (from ti_schedule) to amortise schedule
    construction across sweeps.
    """
    if sched is None:
        sched = ti_schedule(data, mode)
    return _ti_blocked_jit(key, t, T, a, b, tab, data, jnp.asarray(sched),
                           skip_first, legacy_odds)


def ti_pair_layout(data: PYPData):
    """Host-side pair extraction for the pair-major TI sweep: occupied
    (group, category) pairs as index vectors (jvec, ivec, counts)."""
    j_idx, i_idx = np.nonzero(data.n)
    return (j_idx.astype(np.int32), i_idx.astype(np.int32),
            data.n[j_idx, i_idx].astype(np.int32))


def ti_pair_stages(nvec, skip_first: bool = True, min_pairs: int = 512):
    """Host-side round staging for the pair-major TI sweep.

    ``ti_sweep_pairs_state`` runs ``max(count)`` rounds over ALL pairs;
    with CRP-skewed counts (a few pairs of size ~10^3 among thousands of
    size ~10) nearly every lane is masked off in late rounds and the
    sweep runs at a few percent efficiency.  Sorting pairs by descending
    count makes the active set of round ``s`` a PREFIX of the pair axis,
    so rounds can be grouped into stages over shrinking static prefixes:
    stage k processes rounds [r_k, r_{k+1}) over the first P_k pairs,
    with boundaries chosen where the active count halves.  Total work
    drops from max_c * P to <= 2 * sum(count) + tail.

    Returns ``(order, stages)``: ``order`` (np.int32) sorts the pair
    arrays by descending count; ``stages`` is a tuple of
    ``(pairs, r_start, r_stop)`` triples consumed (statically) by
    ``ti_sweep_pairs_staged`` -- which must be called with the SAME
    ``skip_first`` (the first stage's start round encodes it; the sweep
    asserts the match).  ``min_pairs`` stops the halving once a prefix
    is narrow enough that masking costs nothing.
    """
    nvec = np.asarray(nvec)
    order = np.argsort(-nvec, kind="stable").astype(np.int32)
    c = nvec[order]
    P = int(len(c))
    max_c = int(c[0]) if P else 0
    r = 1 if skip_first else 0
    stages = []
    while r < max_c:
        p_act = int((c > r).sum())
        if p_act == 0:
            break
        if p_act <= min_pairs:
            stages.append((p_act, r, max_c))
            break
        k = p_act // 2
        # c sorted desc: #(c > c[k]) <= k, so the active set has halved
        r2 = int(c[k]) if k < P else max_c
        r2 = min(max(r2, r + 1), max_c)
        stages.append((p_act, r, r2))
        r = r2
    return order, tuple(stages)


def _pairs_round(tab, H, nvec, oneh, jvec, a_c, b_c, skip_first: bool,
                 legacy_odds: bool, vrows=None):
    """Build the per-round body shared by the flat and staged pair-major
    TI sweeps; all pair-axis arrays are already sliced to the active
    prefix.

    ``vrows``: optional (P, m_sel) dense V rows (StirlingTable.V_rows):
    when given, the per-round V(n_p, t+1) lookup is a fused
    compare-select-reduce along the m axis instead of a (C, P) point
    gather every round (gather vs. selection on the GPU: ROADMAP A3).
    """
    dt = a_c.dtype
    nif = nvec.astype(dt)[None]                     # (1, P)

    def round_(carry, s):
        tp, T, key = carry
        key, k1, k2 = jax.random.split(key, 3)
        valid = (s < nvec) & (nvec > 1)
        if skip_first:
            valid = valid & (s >= 1)
        valid = valid[None]                          # (1, P)
        Tj = T[:, jvec].astype(dt)                   # round-start totals
        u1 = jax.random.uniform(k1, tp.shape, dt)
        dec = (tp > 1) & ((nif - 1.0) * u1 < (tp - 1).astype(dt)) & valid
        ti2 = tp - dec
        if vrows is not None:
            # V(n_p, ti2+1) = vrows[p, ti2] (vrows col j holds m = j+1);
            # ti2 >= 1 and the m > n / m < 2 zeros are baked into vrows
            mr = jnp.arange(vrows.shape[1], dtype=ti2.dtype)
            sel = ti2[:, :, None] == mr[None, None, :]
            v = jnp.sum(jnp.where(sel, vrows[None], 0.0), axis=-1)
        else:
            v = _vq(tab, nvec[None], ti2 + 1, a_c)
        denom = (nif - ti2.astype(dt) + 1.0) if legacy_odds else jnp.maximum(
            nif - ti2.astype(dt), 1.0)
        one = (H[None] * (b_c + (Tj - dec) * a_c) * ti2.astype(dt)
               / denom * v)
        u2 = jax.random.uniform(k2, tp.shape, dt)
        inc = (u2 < one / (one + 1.0)) & valid & (ti2 < nvec[None])
        tp2 = ti2 + inc
        delta = (tp2 - tp).astype(dt)
        T = T + jax.lax.dot_general(
            delta, oneh, (((1,), (0,)), ((), ())),
            preferred_element_type=dt).astype(T.dtype)
        return (tp2, T, key), None

    return round_


@functools.partial(jax.jit,
                   static_argnames=("stages", "skip_first", "legacy_odds",
                                    "m_sel"))
def ti_sweep_pairs_staged(key, tp, T, a, b, tab: Table, data: PYPData,
                          jvec, ivec, nvec, stages,
                          skip_first: bool = True,
                          legacy_odds: bool = False, m_sel: int = 0):
    """Staged pair-major TI sweep: ``ti_sweep_pairs_state`` semantics with
    the pair axis PRE-SORTED by descending count (``ti_pair_stages``
    order) so late rounds touch only the still-active prefix.

    ``stages`` is the static tuple from ``ti_pair_stages``; each stage
    scans its round range over a static prefix slice of the pair state,
    cutting the work on skewed count distributions by 1-2 orders of
    magnitude (check.c-scale: ~9x measured, see bench.py).  Within a
    round the same round-start-T approximation applies (validated at
    scale in tests/test_models.py).  Returns (tp, T) in sorted order.

    ``stages`` must have been built by ``ti_pair_stages`` with the SAME
    ``skip_first`` as passed here (the first stage's start round encodes
    it); a mismatch would silently skip or repeat round 0, so it is
    asserted at trace time.

    ``m_sel`` > 0 (static, = max(count)+1) enables the gather-free V
    path for fixed-a StirlingTables: per-pair V rows are extracted once
    per sweep (StirlingTable.V_rows) and each round selects within rows
    by a fused compare-reduce (see _pairs_round).  The
    ``ti_sweep_pairs`` wrapper sets it automatically when legal.
    """
    if stages and stages[0][1] != (1 if skip_first else 0):
        raise ValueError(
            f"stages built with skip_first={stages[0][1] == 1}, sweep "
            f"called with skip_first={skip_first}: rebuild stages via "
            f"ti_pair_stages(nvec, skip_first={skip_first})")
    dt = a.dtype
    J = data.n.shape[0]
    P = tp.shape[1]
    Hfull = jnp.asarray(data.H, dt)[ivec]           # (P,)
    nvec = jnp.asarray(nvec)
    a_c = a[:, None]
    b_c = b[:, None]
    vrows = tab.V_rows(nvec, m_sel) if m_sel else None
    for (p, r0, r1) in stages:
        round_ = _pairs_round(tab, Hfull[:p], nvec[:p],
                              jax.nn.one_hot(jvec[:p], J, dtype=dt),
                              jvec[:p], a_c, b_c, skip_first, legacy_odds,
                              vrows=None if vrows is None else vrows[:p])
        (tps, T, key), _ = jax.lax.scan(
            round_, (tp[:, :p], T, key),
            jnp.arange(r0, r1, dtype=jnp.int32))
        # stage boundaries are static jit args, so a different count
        # distribution (or min_pairs) recompiles; acceptable for the
        # fixed-data bench/sweep usage -- if this ever runs with data
        # that changes shape mid-run, bucket the boundaries instead
        tp = tps if p == P else jnp.concatenate([tps, tp[:, p:]], axis=1)
    return tp, T


@functools.partial(jax.jit,
                   static_argnames=("steps", "skip_first", "legacy_odds",
                                    "m_sel"))
def ti_sweep_pairs_state(key, tp, T, a, b, tab: Table, data: PYPData,
                         jvec, ivec, nvec, steps: int,
                         skip_first: bool = True,
                         legacy_odds: bool = False, m_sel: int = 0):
    """Pair-major table-indicator sweep: the check.c-scale throughput
    kernel (check.c:843-867 at MAXDATA=10^5, check.c:83).

    The scheduled form (``ti_sweep_blocked``) gathers/scatters dense
    (C, J, D) state every scan step.  Here the observation is that the TI kernel
    never uses the item identity: occurrence s of pair p performs the
    same conditional update for every s (the first occurrence is forced
    when ``skip_first``), so a sweep is just ``steps = max count`` rounds
    in which EVERY pair with ``s < count_p`` updates once:

    * ``tp`` (C, P) holds the table counts pair-major -- each round is
      pure elementwise, no scatter anywhere;
    * the group totals update via one (C, P) @ (P, J) one-hot matmul
      (exact integer deltas, |T| << 2^24: exact in TF32 too);
    * Stirling V queries are one gather per round.

    Within a round, pairs of the same group read the round-start total T
    (the same block-start approximation as ``ti_sweep_blocked``'s cat
    mode, validated against the sequential sweep at scale in
    tests/test_models.py); rounds update T exactly.  Returns (tp, T).
    """
    dt = a.dtype
    J = data.n.shape[0]
    H = jnp.asarray(data.H, dt)[ivec]               # (P,)
    nvec = jnp.asarray(nvec)
    vrows = tab.V_rows(nvec, m_sel) if m_sel else None
    round_ = _pairs_round(tab, H, nvec, jax.nn.one_hot(jvec, J, dtype=dt),
                          jvec, a[:, None], b[:, None], skip_first,
                          legacy_odds, vrows=vrows)
    (tp, T, _), _ = jax.lax.scan(round_, (tp, T, key),
                                 jnp.arange(steps, dtype=jnp.int32))
    return tp, T


def ti_pair_m_sel(tab: Table, nvec, cap: int = 4096) -> int:
    """Static m_sel for the gather-free V path of the pair-major TI
    sweeps, or 0 when it does not apply.

    Legal when ``tab`` is a fixed-a StirlingTable that covers every
    (n_p, t+1) query in-table (so the dense
    row extraction agrees exactly with the gather path), and the row
    length stays below ``cap`` (the selection reduce is O(m_sel) per
    pair per round -- past a few thousand columns the point gather wins
    back).
    """
    nvec = np.asarray(nvec)
    if (not isinstance(tab, stirling.StirlingTable) or tab.vtab is None
            or len(nvec) == 0):
        return 0
    maxc = int(nvec.max())
    if maxc + 1 > min(tab.m_max, cap) or maxc > tab.n_max:
        return 0
    return maxc + 1


def ti_sweep_pairs(key, t, T, a, b, tab: Table, data: PYPData,
                   layout=None, skip_first: bool = True,
                   legacy_odds: bool = False, staged: bool = True,
                   min_pairs: int = 512):
    """Dense-state wrapper of the pair-major TI sweeps: converts the
    (C, J, D) table-count state to pair-major and back (one gather + one
    static-index scatter per sweep, amortised over all rounds).  Pass a
    precomputed ``layout`` (from ``ti_pair_layout``) to skip the host
    extraction.  ``staged=True`` (default) sorts pairs by descending
    count and runs the shrinking-prefix schedule (``ti_pair_stages``) so
    CRP-skewed counts don't leave most lanes masked; ``staged=False``
    keeps the flat max-count schedule."""
    if layout is None:
        layout = ti_pair_layout(data)
    jvec, ivec, nvec = layout
    m_sel = ti_pair_m_sel(tab, nvec)
    if staged and len(nvec):
        order, stages = ti_pair_stages(nvec, skip_first=skip_first,
                                       min_pairs=min_pairs)
        jvec, ivec, nvec = jvec[order], ivec[order], nvec[order]
        jv = jnp.asarray(jvec)
        iv = jnp.asarray(ivec)
        tp = t[:, jv, iv]
        tp, T = ti_sweep_pairs_staged(key, tp, T, a, b, tab, data, jv, iv,
                                      jnp.asarray(nvec), stages,
                                      skip_first=skip_first,
                                      legacy_odds=legacy_odds, m_sel=m_sel)
        return t.at[:, jv, iv].set(tp), T
    steps = int(nvec.max()) if len(nvec) else 0
    jv = jnp.asarray(jvec)
    iv = jnp.asarray(ivec)
    tp = t[:, jv, iv]
    tp, T = ti_sweep_pairs_state(key, tp, T, a, b, tab, data, jv, iv,
                                 jnp.asarray(nvec), steps,
                                 skip_first=skip_first,
                                 legacy_odds=legacy_odds, m_sel=m_sel)
    return t.at[:, jv, iv].set(tp), T


def init_hsa(data: PYPData, chains: int, smax: Optional[int] = None):
    """Histogram seating state: one table of size n per occupied category
    (matching init_state's one-table init).  Returns (hist, T):
    hist[c, j, i, s] = number of tables of size s serving category i in
    group j; size axis is 0..smax."""
    if smax is None:
        smax = int(data.n.max())
    J, D = data.n.shape
    h0 = np.zeros((J, D, smax + 1), np.int32)
    for j in range(J):
        for i in range(D):
            if data.n[j, i] > 0:
                h0[j, i, data.n[j, i]] = 1
    hist = jnp.broadcast_to(jnp.asarray(h0), (chains,) + h0.shape)
    T = jnp.broadcast_to(jnp.asarray((data.n > 0).sum(axis=1), jnp.int32),
                         (chains, J))
    return hist, T


@functools.partial(jax.jit, static_argnames=())
def hsa_sweep(key, hist, T, a, b, data: PYPData):
    """Histogrammed seating-arrangement Gibbs sweep (check.c's SA/HSA
    samplers, check.c:716-842).

    The SA sampler tracks every table's occupancy explicitly; HSA keeps
    only the histogram of table sizes per (group, category) -- an exact
    collapse, since the seating posterior depends on sizes alone.  Per
    item: unseat one uniformly-chosen customer of that category (a table
    of size s is chosen with prob ∝ s h_s), then reseat at an existing
    table (∝ (s - a) h_s) or a new one (∝ (b + T a) H_i).

    hist: (C, J, D, S+1) int32; T: (C, J); a, b: (C,).
    Returns (hist, T).  Table counts derive as t = hist.sum(-1).

    SCOPE: this is the SMALL-SCALE ORACLE form, deliberately
    item-sequential like the reference (check.c:766-842); the scale
    route is ``hsa_sweep_pairs`` (staged pair-major rounds).  The
    pair-major round streams the dense (chains, pairs, sizes) histogram
    through ~18 full-array passes (two size-axis cumsums and their
    shift-adds), so it is memory-bound well below TI/CTW, which avoid
    carrying a size axis altogether -- those remain the scale kernels.
    """
    dt = a.dtype
    cats = jnp.asarray(data.data_cat)
    grps = jnp.asarray(data.data_grp)
    n = jnp.asarray(data.n)
    H = jnp.asarray(data.H, dt)
    S = hist.shape[-1] - 1
    svec = jnp.arange(S + 1)                      # sizes 0..S
    sf = svec.astype(dt)

    def item(carry, inp):
        hist, T, key = carry
        i, j = inp
        key, k1, k2 = jax.random.split(key, 3)
        h = hist[:, j, i, :]                      # (C, S+1)
        ni = n[j, i]
        live = ni > 0
        # -- unseat: P(table size s) ∝ s h_s ------------------------------
        lw = jnp.log(jnp.maximum(sf[None] * h.astype(dt), 0.0))
        lw = jnp.where((svec[None] >= 1) & (h > 0), lw, -jnp.inf)
        g1 = jax.random.gumbel(k1, lw.shape, dt)
        s_rm = jnp.argmax(lw + g1, axis=-1)       # (C,)
        oh_rm = jax.nn.one_hot(s_rm, S + 1, dtype=h.dtype)
        oh_rm1 = jax.nn.one_hot(jnp.maximum(s_rm - 1, 0), S + 1,
                                dtype=h.dtype) * (s_rm > 1)[:, None]
        h = h - oh_rm + oh_rm1                    # size-1 table vanishes
        Tj = T[:, j] - (s_rm == 1)
        # -- reseat: existing ∝ (s - a) h_s, new ∝ (b + T a) H_i ----------
        lw2 = jnp.log(jnp.maximum(
            (sf[None] - a[:, None]) * h.astype(dt), 0.0))
        lw2 = jnp.where((svec[None] >= 1) & (h > 0), lw2, -jnp.inf)
        lnew = jnp.log(jnp.maximum(
            (b + Tj.astype(dt) * a) * H[i], 1e-30))[:, None]
        lw2 = jnp.concatenate([lw2, lnew], axis=-1)
        g2 = jax.random.gumbel(k2, lw2.shape, dt)
        pick = jnp.argmax(lw2 + g2, axis=-1)      # S+1 == "new table"
        is_new = pick == S + 1
        s_join = jnp.where(is_new, 0, pick)
        oh_join = jax.nn.one_hot(s_join, S + 1, dtype=h.dtype) * (
            ~is_new)[:, None]
        oh_joinp = jax.nn.one_hot(jnp.minimum(s_join + 1, S), S + 1,
                                  dtype=h.dtype) * (~is_new)[:, None]
        oh_new = jax.nn.one_hot(1, S + 1, dtype=h.dtype)[None] * (
            is_new)[:, None]
        h = h - oh_join + oh_joinp + oh_new
        Tj = Tj + is_new
        hist = jnp.where(live, hist.at[:, j, i, :].set(h), hist)
        T = jnp.where(live, T.at[:, j].set(Tj), T)
        return (hist, T, key), None

    (hist, T, _), _ = jax.lax.scan(item, (hist, T, key), (cats, grps))
    return hist, T


def init_hsa_pairs(data: PYPData, chains: int, order=None,
                   s_max: Optional[int] = None):
    """Pair-major histogram seating state: hp[c, p, s] = number of
    tables of size s for occupied pair p (init: one table of size n_p,
    matching init_hsa/init_state).  ``order`` (from ti_pair_stages)
    pre-sorts the pair axis for the staged sweep."""
    jvec, ivec, nvec = ti_pair_layout(data)
    if order is not None:
        jvec, ivec, nvec = jvec[order], ivec[order], nvec[order]
    if s_max is None:
        s_max = int(nvec.max()) if len(nvec) else 1
    P = len(nvec)
    h0 = np.zeros((P, s_max + 1), np.int32)
    h0[np.arange(P), nvec] = 1
    hp = jnp.broadcast_to(jnp.asarray(h0), (chains, P, s_max + 1))
    T = jnp.broadcast_to(jnp.asarray(
        (data.n > 0).sum(axis=1), jnp.int32), (chains, data.n.shape[0]))
    return hp, T


def _hsa_pairs_round(nvec, oneh, jvec, Hp, a_c, b_c, s_max: int):
    """Per-round body of the staged pair-major HSA sweep: every active
    pair unseats one customer and reseats it, entirely by dense size-axis
    algebra (inverse-CDF categoricals over cumsums; one-hot updates by
    iota compares -- no gathers, no scatters)."""
    dt = a_c.dtype
    svec = jnp.arange(s_max + 1, dtype=dt)              # (S+1,)
    sint = jnp.arange(s_max + 1, dtype=jnp.int32)
    a3 = a_c[:, :, None]                                # (C,1,1)

    def round_(carry, s):
        hp, T, key = carry
        key, k1, k2 = jax.random.split(key, 3)
        valid = (s < nvec) & (nvec >= 1)                 # (P,)
        hf = hp.astype(dt)
        # -- unseat: P(size s) = s h_s / n_p (inverse CDF; minval guards
        # the measure-zero u == 0 draw from picking index 0)
        c1 = jnp.cumsum(svec[None, None, :] * hf, axis=-1)
        u1 = jax.random.uniform(k1, hp.shape[:2], dt, minval=1e-6)
        s_rm = jnp.sum(c1 < (u1 * c1[..., -1])[..., None],
                       axis=-1).astype(jnp.int32)
        s_rm = jnp.clip(s_rm, 1, s_max)
        rm = sint[None, None, :] == s_rm[..., None]
        rm1 = (sint[None, None, :] == (s_rm - 1)[..., None]) \
            & (s_rm > 1)[..., None]
        h2 = hp - rm + rm1
        single = s_rm == 1                               # table vanished
        T_loc = T[:, jvec].astype(dt) - single.astype(dt)
        # -- reseat: existing P(s) prop. (s - a) h_s, new prop.
        # (b + T a) H_p (round-local T; cross-pair lag is the same
        # round-start approximation the TI pair sweeps validate)
        h2f = h2.astype(dt)
        w2 = jnp.maximum(svec[None, None, :] - a3, 0.0) * h2f
        c2 = jnp.cumsum(w2, axis=-1)
        tot2 = c2[..., -1]
        wnew = (b_c + T_loc * a_c) * Hp[None, :]
        u2 = jax.random.uniform(k2, hp.shape[:2], dt,
                                minval=1e-6) * (tot2 + wnew)
        is_new = u2 >= tot2
        s_jn = jnp.sum(c2 < u2[..., None], axis=-1).astype(jnp.int32)
        s_jn = jnp.clip(s_jn, 1, s_max - 1)
        ex = (~is_new)[..., None]
        jn0 = (sint[None, None, :] == s_jn[..., None]) & ex
        jn1 = (sint[None, None, :] == (s_jn + 1)[..., None]) & ex
        new1 = (sint[None, None, :] == 1) & is_new[..., None]
        h3 = h2 - jn0 + jn1 + new1
        v3 = valid[None, :, None]
        hp = jnp.where(v3, h3, hp)
        dT = jnp.where(valid[None, :],
                       (is_new.astype(dt) - single.astype(dt)), 0.0)
        T = T + jax.lax.dot_general(
            dT, oneh, (((1,), (0,)), ((), ())),
            preferred_element_type=dt).astype(T.dtype)
        return (hp, T, key), None

    return round_


@functools.partial(jax.jit, static_argnames=("stages", "s_max"))
def hsa_sweep_pairs_staged(key, hp, T, a, b, data: PYPData, jvec, ivec,
                           nvec, stages, s_max: int):
    """Staged pair-major HSA sweep: the scale route for the histogram
    seating-arrangement sampler (check.c:766-842 semantics).

    Like ti_sweep_pairs_staged, a sweep is max(count) rounds in which
    every pair with ``s < count_p`` processes one item (unseat one
    customer, reseat it), over shrinking count-sorted prefixes
    (``stages`` from ti_pair_stages(skip_first=False)).  All histogram
    surgery is dense size-axis algebra -- inverse-CDF categoricals over
    cumsums and iota-compare one-hots -- so the round is a dense
    elementwise stream with no gathers or scatters.  Within
    a round, same-group pairs read the round-start group total T for the
    new-table weight (the lag approximation the TI pair sweeps validate
    statistically at scale); T updates exactly between rounds.

    hp: (C, P, s_max+1) int32 (init_hsa_pairs, pre-sorted by ``order``);
    the histogram invariant sum_s s h_s = n_p is preserved exactly.
    Returns (hp, T).
    """
    if stages and stages[0][1] != 0:
        raise ValueError(
            "hsa stages must be built with ti_pair_stages(skip_first="
            "False) -- HSA resamples every item")
    dt = a.dtype
    J = data.n.shape[0]
    P = hp.shape[1]
    Hfull = jnp.asarray(data.H, dt)[ivec]
    nvec = jnp.asarray(nvec)
    a_c = a[:, None]
    b_c = b[:, None]
    for (p, r0, r1) in stages:
        round_ = _hsa_pairs_round(nvec[:p],
                                  jax.nn.one_hot(jvec[:p], J, dtype=dt),
                                  jvec[:p], Hfull[:p], a_c, b_c, s_max)
        (hps, T, key), _ = jax.lax.scan(
            round_, (hp[:, :p], T, key),
            jnp.arange(r0, r1, dtype=jnp.int32))
        hp = hps if p == P else jnp.concatenate([hps, hp[:, p:]], axis=1)
    return hp, T


def hsa_sweep_pairs(key, hp, T, a, b, data: PYPData, layout=None,
                    order=None, stages=None, min_pairs: int = 512):
    """Wrapper building the count-sorted layout/stages for
    hsa_sweep_pairs_staged (pass precomputed pieces to amortise).  The
    pair axis of ``hp`` must already be in ``order`` (init_hsa_pairs
    does this when given the same order)."""
    if layout is None:
        layout = ti_pair_layout(data)
    jvec, ivec, nvec = layout
    if order is None or stages is None:
        order, stages = ti_pair_stages(nvec, skip_first=False,
                                       min_pairs=min_pairs)
    jvec, ivec, nvec = jvec[order], ivec[order], nvec[order]
    s_max = hp.shape[-1] - 1
    return hsa_sweep_pairs_staged(key, hp, T, a, b, data,
                                  jnp.asarray(jvec), jnp.asarray(ivec),
                                  jnp.asarray(nvec), stages, s_max)


def _ct_conditional(tab, ni, ti, Tj, a, b, Hi, tmax: int, window,
                    ti_off=None, maxrel=None):
    """Masked log-weights over candidate t values (check.c:877-895).

    Weight(tt) proportional to  S(n,tt) * prod_{k=1}^{tt-1} H_i (b + (T - t_i + k) a)
    -- evaluated in log space relative to nothing (categorical is
    shift-invariant, so the reference's division by S(n, t_i) drops out).

    ni and Hi may be scalars (shared data) or (C,) per-chain values (the
    hierarchical case, where counts and base probabilities at one level
    are state of the level below).  ``ti_off`` is the stored table count
    subtracted from the total Tj to get the other-categories total; it
    defaults to ``ti`` but differs in the dynamic-n (hierarchical) case
    where ``ti`` has been clamped to a shrunk n while Tj still carries the
    stale stored count.

    ``maxrel``: check.c's '-c' bound (check.c:289,318,342,893): the
    reference's scalar loop STOPS at the first candidate tt > t_i + 3
    whose weight has dropped maxrel-fold below the running peak, so all
    later tt are excluded from the draw.  The vectorised analog masks
    every candidate at or beyond that first cut (cumulative-or), making
    the truncated kernel identical to the reference's, not merely
    approximately so.
    """
    dt = a.dtype
    if ti_off is None:
        ti_off = ti
    tts = jnp.arange(1, tmax + 1)
    ni_c = jnp.asarray(ni)
    ni_col = ni_c[:, None] if ni_c.ndim == 1 else ni_c
    hi_c = jnp.asarray(Hi, dt)
    hi_col = hi_c[:, None] if hi_c.ndim == 1 else hi_c
    # log prod term: cumsum over k of log(H_i (b + (T - ti + k) a)), k=1..tt-1
    ks = jnp.arange(1, tmax + 1).astype(dt)          # k = 1..tmax
    base = jnp.log(jnp.maximum(hi_col, 1e-30)) + jnp.log(jnp.maximum(
        b[:, None] + (Tj - ti_off)[:, None].astype(dt) * a[:, None]
        + ks[None, :] * a[:, None], 1e-300 if dt == jnp.float64 else 1e-30))
    cum = jnp.cumsum(base, axis=-1)
    hterm = jnp.concatenate([jnp.zeros_like(cum[:, :1]), cum[:, :-1]], axis=-1)
    srel = _srelq(tab, ni_col, tts[None, :], a[:, None])
    lw = hterm + srel
    ok = tts[None, :] <= ni_col
    if window is not None:
        ok = ok & (jnp.abs(tts[None, :] - ti[:, None]) <= window)
    lw = jnp.where(ok, lw, -jnp.inf)
    if maxrel is not None:
        run_peak = jax.lax.cummax(lw, axis=lw.ndim - 1)
        cut = ((tts[None, :] > ti[:, None] + 3)
               & (run_peak - lw > jnp.log(jnp.asarray(maxrel, lw.dtype))))
        dead = jnp.cumsum(cut.astype(jnp.int32), axis=-1) > 0
        lw = jnp.where(dead, -jnp.inf, lw)
    return lw


@functools.partial(jax.jit, static_argnames=("tmax", "window", "maxrel"))
def ct_sweep(key, t, T, a, b, tab: Table, data: PYPData, tmax: int,
             window: Optional[int] = None, n_arr=None, H_arr=None,
             maxrel: Optional[float] = None):
    """Collapsed-table sweep (check.c:868-904; window: check.c:905-943).

    For each (group, category): resample t_i from its full conditional
    via a Gumbel-max categorical over 1..tmax.

    ``n_arr`` (C, J, D) / ``H_arr`` (C, D) override the fixed data counts
    and base distribution with per-chain values -- the hierarchical-PYP
    case where this level's n are the level below's table counts and the
    base is its posterior predictive.

    Groups are independent restaurants given (a, b), so the sweep scans
    only the D categories and resamples all (chain, group) pairs of each
    category simultaneously -- J-fold more parallel work per sequential
    step than the reference's doubly-nested loop (check.c:869-875).
    """
    n = jnp.asarray(data.n)
    H = jnp.asarray(data.H, a.dtype)
    J, D = data.n.shape
    C = t.shape[0]
    a_f = jnp.broadcast_to(a[:, None], (C, J)).reshape(-1)
    b_f = jnp.broadcast_to(b[:, None], (C, J)).reshape(-1)

    def cat(carry, i):
        t, T, key = carry
        key, kg = jax.random.split(key)
        if n_arr is None:
            ni = jnp.broadcast_to(n[None, :, i], (C, J)).reshape(-1)
        else:
            ni = n_arr[:, :, i].reshape(-1)
        if H_arr is None:
            Hi = jnp.broadcast_to(H[i], (C * J,))
        else:
            Hi = jnp.broadcast_to(H_arr[:, i, None], (C, J)).reshape(-1)
        ti_stored = t[:, :, i].reshape(-1)
        Tj = T.reshape(-1)
        ti = jnp.minimum(ti_stored, ni.astype(ti_stored.dtype))  # dyn-n guard
        # Tj still counts the stale stored t during a dynamic-n transient,
        # so the other-categories offset must subtract the stored value
        lw = _ct_conditional(tab, ni, ti, Tj, a_f, b_f, Hi, tmax, window,
                             ti_off=ti_stored, maxrel=maxrel)
        g = jax.random.gumbel(kg, lw.shape, a.dtype)
        tt = 1 + jnp.argmax(lw + g, axis=-1).astype(t.dtype)
        tt = jnp.where(ni > 0, tt, jnp.zeros_like(ti))
        T = (Tj + tt - t[:, :, i].reshape(-1)).reshape(C, J)
        t = t.at[:, :, i].set(tt.reshape(C, J))
        return (t, T, key), None

    (t, T, _), _ = jax.lax.scan(cat, (t, T, key), jnp.arange(D))
    return t, T


def ctw_sweep(key, t, T, a, b, tab: Table, data: PYPData, tmax: int,
              window: int = 10):
    """Windowed collapsed sweep (check.c:905-943, TWINDOW default 10)."""
    return ct_sweep(key, t, T, a, b, tab, data, tmax, window=window)


def ctw_m_sel(tab: Table, data: PYPData, window: int = 10,
              cap: int = 4096) -> int:
    """Static m_sel for ctw_sweep_rel's gather-free Srel path, or 0 when
    it does not apply (same gating as ti_pair_m_sel).  m_sel = maxc+1
    suffices for any window: candidates past n_i are -inf-masked by the
    sweep regardless of row coverage (``window`` kept for signature
    stability; it does not affect the result)."""
    del window
    maxc = int(np.asarray(data.n).max()) if data.n.size else 0
    m_sel = maxc + 1
    if (not isinstance(tab, stirling.StirlingTable) or tab.srel is None
            or maxc == 0):
        return 0
    if m_sel > min(tab.m_max, cap) or maxc > tab.n_max:
        return 0
    return m_sel


@functools.partial(jax.jit, static_argnames=("window", "m_sel"))
def ctw_sweep_rel(key, t, T, a, b, tab: Table, data: PYPData,
                  window: int = 10, m_sel: int = 0):
    """Windowed collapsed sweep with RELATIVE candidates (check.c:905-943).

    ct_sweep builds the full 1..tmax candidate range and masks a window
    out of it -- O(tmax) work per (chain, group) even though only
    2*window+1 candidates matter, hopeless at check.c scale where counts
    reach 10^5 (check.c:83).  Here candidates are t_i + [-w, w], so per
    category the work is O(C * J * (2w+1)) regardless of the counts.

    The window clamps into [1, n_i] by shifting (the reference clamps the
    ends the same way, check.c:915-918); weights follow _ct_conditional's
    derivation with the reference's relative-to-current-t form.

    ``m_sel`` > 0 (static, = max(count)+1, via ``ctw_m_sel``): the
    per-category Srel window gather is replaced by dense per-(group,
    category) Srel rows (StirlingTable.Srel_rows, one one-hot
    contraction per sweep) plus a fused compare-select-reduce (gather
    vs. selection on the GPU: ROADMAP A3).  Fixed-a StirlingTables only;
    per-chain-a AGridTables keep the gather.
    """
    dt = a.dtype
    n = jnp.asarray(data.n)
    H = jnp.asarray(data.H, dt)
    J, D = data.n.shape
    C = t.shape[0]
    a_f = jnp.broadcast_to(a[:, None], (C, J)).reshape(-1)
    b_f = jnp.broadcast_to(b[:, None], (C, J)).reshape(-1)
    offs = jnp.arange(-window, window + 1)        # (K,)
    K = offs.shape[0]
    if m_sel:
        # (D, J, m_sel) dense Srel rows for every (group, category) count
        srows = tab.Srel_rows(n.T.reshape(-1), m_sel).reshape(D, J, m_sel)

    def cat(carry, i):
        t, T, key = carry
        key, kg = jax.random.split(key)
        ni = jnp.broadcast_to(n[None, :, i], (C, J)).reshape(-1)
        Hi = jnp.broadcast_to(H[i], (C * J,))
        ti = t[:, :, i].reshape(-1)
        Tj = T.reshape(-1)
        # candidate window [lo, lo+K-1] kept inside [1, ni]
        lo = jnp.clip(ti - window, 1, jnp.maximum(ni - K + 1, 1))
        tts = lo[:, None] + offs[None, :] + window  # = lo..lo+2w  (P, K)
        # log prod_{k=1}^{tt-1} H (b + (T - ti + k) a): cumulative in tt;
        # evaluate as lgamma differences to keep it O(K) per pair:
        #   sum_{k=1}^{m} log(b + (T-ti)a + k a)
        #     = m log(a) + lgamma((b + (T-ti)a)/a + m + 1)
        #               - lgamma((b + (T-ti)a)/a + 1)           (a > 0)
        base = (b_f + (Tj - ti).astype(dt) * a_f) / jnp.maximum(a_f, 1e-12)
        mm = (tts - 1).astype(dt)
        hlog = jnp.log(jnp.maximum(Hi, 1e-30))
        safe_a = jnp.maximum(a_f, 1e-12)
        cum = (mm * (hlog + jnp.log(safe_a))[:, None]
               + jax.lax.lgamma(base[:, None] + mm + 1.0)
               - jax.lax.lgamma(base[:, None] + 1.0))
        # a == 0 chains: sum log(b) = m log b
        cum0 = mm * (hlog + jnp.log(jnp.maximum(b_f, 1e-30)))[:, None]
        cum = jnp.where(a_f[:, None] > 0, cum, cum0)
        if m_sel:
            rows_i = srows[i]                            # (J, m_sel)
            mr = jnp.arange(1, m_sel + 1, dtype=tts.dtype)
            sel = tts.reshape(C, J, K)[..., None] == mr  # (C, J, K, m_sel)
            # selection (not multiplication), so the -inf above-diagonal
            # row entries pass through exactly as Srel() returns them;
            # tts beyond m_sel select nothing (0), and are > ni so the
            # ok-mask below -infs them anyway
            srel = jnp.sum(jnp.where(sel, rows_i[None, :, None, :],
                                     jnp.zeros((), dt)), axis=-1)
            srel = srel.reshape(C * J, K)
        else:
            srel = _srelq(tab, ni[:, None], tts, a_f[:, None])
        lw = cum + srel
        ok = (tts >= 1) & (tts <= ni[:, None])
        lw = jnp.where(ok, lw, -jnp.inf)
        g = jax.random.gumbel(kg, lw.shape, dt)
        pick = jnp.argmax(lw + g, axis=-1)
        tt = jnp.take_along_axis(tts, pick[:, None], axis=-1)[:, 0]
        tt = tt.astype(t.dtype)
        tt = jnp.where(ni > 0, tt, jnp.zeros_like(ti))
        T = (Tj + tt - ti).reshape(C, J)
        t = t.at[:, :, i].set(tt.reshape(C, J))
        return (t, T, key), None

    (t, T, _), _ = jax.lax.scan(cat, (t, T, key), jnp.arange(D))
    return t, T
