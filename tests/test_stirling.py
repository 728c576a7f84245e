"""L1 Stirling table golden + precision tests.

Golden values come from exact rational arithmetic on the defining
recurrence S^n_m = S^{n-1}_{m-1} + (n-1 - m a) S^{n-1}_m (stable.c:380-387)
-- the oracle infrastructure the reference lacks (SURVEY.md §4).
"""
from fractions import Fraction
import math

import numpy as np
import pytest
import jax.numpy as jnp

from libstb_jax.core import stirling


def exact_logS(a_frac: Fraction, n_max: int):
    """Exact log S^n_{m,a} table via Fractions; returns dict[(n,m)] -> float."""
    S = {(1, 1): Fraction(1)}
    for n in range(2, n_max + 1):
        for m in range(1, n + 1):
            prev = S.get((n - 1, m), Fraction(0))
            diag = S.get((n - 1, m - 1), Fraction(0))
            S[(n, m)] = diag + (Fraction(n - 1) - m * a_frac) * prev
    out = {}
    for (n, m), v in S.items():
        if v > 0:
            # log of a big Fraction accurately
            out[(n, m)] = math.log(v.numerator) - math.log(v.denominator)
    return out


A_FRAC = Fraction(1, 2)
NEX = 40
EXACT = exact_logS(A_FRAC, NEX)


@pytest.fixture(scope="module")
def table64():
    return stirling.make(NEX, NEX, 200, 100, float(A_FRAC), dtype=jnp.float64)


@pytest.fixture(scope="module")
def table32():
    return stirling.make(NEX, NEX, 200, 100, float(A_FRAC), dtype=jnp.float32)


def test_S_golden_f64(table64):
    ns, ms, want = [], [], []
    for (n, m), v in EXACT.items():
        ns.append(n); ms.append(m); want.append(v)
    got = np.asarray(table64.S(jnp.array(ns), jnp.array(ms)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_S_golden_f32(table32):
    ns, ms, want = [], [], []
    for (n, m), v in EXACT.items():
        ns.append(n); ms.append(m); want.append(v)
    got = np.asarray(table32.S(jnp.array(ns), jnp.array(ms)))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def test_V_golden(table64):
    ns, ms, want = [], [], []
    for (n, m), v in EXACT.items():
        if m >= 2 and (n, m - 1) in EXACT:
            ns.append(n); ms.append(m)
            want.append(math.exp(v - EXACT[(n, m - 1)]))
    got = np.asarray(table64.V(jnp.array(ns), jnp.array(ms)))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_S1(table64):
    from scipy.special import gammaln
    n = np.arange(1, NEX + 1)
    want = gammaln(n - 0.5) - gammaln(0.5)
    got = np.asarray(table64.S1(jnp.array(n)))
    np.testing.assert_allclose(got, want, rtol=1e-13)


def test_identities(table64):
    # n==m -> 0; m==1 -> S1; n<m -> -inf; m==0 -> -inf  (stable.c:944-949)
    assert float(table64.S(7, 7)) == 0.0
    assert np.isneginf(float(table64.S(3, 5)))
    assert np.isneginf(float(table64.S(3, 0)))
    np.testing.assert_allclose(float(table64.S(9, 1)), float(table64.S1(9)), rtol=1e-14)


def test_U_UV(table64):
    # U^n_m = S^{n+1}_m / S^n_m ; UV identities (stable.c:875-897)
    for (n, m) in [(10, 3), (20, 7), (30, 2)]:
        want_u = math.exp(EXACT[(n + 1, m)] - EXACT[(n, m)])
        np.testing.assert_allclose(float(table64.U(n, m)), want_u, rtol=1e-10)
        np.testing.assert_allclose(
            float(table64.UV(n, m)),
            math.exp(EXACT[(n + 1, m)] - EXACT[(n, m - 1)]), rtol=1e-10)
    np.testing.assert_allclose(float(table64.U(5, 1)), 5 - 0.5, rtol=1e-14)
    assert float(table64.UV(5, 6)) == 1.0
    np.testing.assert_allclose(float(table64.UV(5, 5)), 6.0 / 4.0, rtol=1e-14)


def test_asympt_close_to_exact():
    # list.c:98-109 pattern: asymptote vs exact at moderate n
    t = stirling.make(1000, 50, 1000, 50, 0.5, use_asympt=True, dtype=jnp.float64)
    n = 1000
    for m in (2, 5, 10):
        exact = float(t.S(n, m))
        asy = float(stirling.s_asympt(0.5, float(t.lga1), n, m))
        assert abs(asy - exact) / abs(exact) < 1e-2
    # beyond max_n the query falls back to the asymptote
    beyond = float(t.S(2000, 5))
    direct = float(stirling.s_asympt(0.5, float(t.lga1), 2000, 5))
    np.testing.assert_allclose(beyond, direct, rtol=1e-12)


def test_bounds_no_asympt():
    t = stirling.make(50, 20, 50, 20, 0.5, use_asympt=False, dtype=jnp.float64)
    assert np.isneginf(float(t.S(51, 5)))
    assert float(t.V(51, 5)) == 0.0


def test_extend_n_growth_matches_fresh():
    t = stirling.make(50, 30, 4000, 2000, 0.5, dtype=jnp.float64)
    t2 = stirling.ensure(t, 200, 20)
    assert t2.n_max >= 201
    fresh = stirling.make(t2.n_max, t2.m_max, 4000, 2000, 0.5, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(t2.vtab[1:, 1:]),
                               np.asarray(fresh.vtab[1:, 1:]), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(t2.srel[:, :30]),
                               np.asarray(fresh.srel[:, :30]),
                               rtol=1e-9, atol=1e-9)


def test_extend_m_growth_matches_fresh():
    t = stirling.make(100, 20, 4000, 2000, 0.5, dtype=jnp.float64)
    t2 = stirling.ensure(t, 80, 60)
    assert t2.m_max >= 61
    fresh = stirling.make(t2.n_max, t2.m_max, 4000, 2000, 0.5, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(t2.vtab[1:, 1:]),
                               np.asarray(fresh.vtab[1:, 1:]), rtol=1e-12)


def test_remake(table64):
    t2 = stirling.remake(table64, 0.25)
    ex = exact_logS(Fraction(1, 4), 20)
    for (n, m) in [(10, 3), (20, 7)]:
        np.testing.assert_allclose(float(t2.S(n, m)), ex[(n, m)], atol=1e-11)


def test_f32_vs_f64_precision_ratio_recursion():
    """precision_test.c:10-13 analog: the f32 ratio fill tracks f64 to
    near-roundoff even at n=2000 (no N-direction drift by construction)."""
    n, m = 2000, 200
    t32 = stirling.make(n, m, n, m, 0.5, dtype=jnp.float32)
    t64 = stirling.make(n, m, n, m, 0.5, dtype=jnp.float64)
    v32 = np.asarray(t32.vtab[-1, 1:m]).astype(np.float64)
    v64 = np.asarray(t64.vtab[-1, 1:m])
    np.testing.assert_allclose(v32, v64, rtol=2e-5)
    # Srel (the sampler-facing difference form) stays accurate too
    s32 = np.asarray(t32.Srel(jnp.full(5, n), jnp.array([2, 5, 50, 100, 200])))
    s64 = np.asarray(t64.Srel(jnp.full(5, n), jnp.array([2, 5, 50, 100, 200])))
    np.testing.assert_allclose(s32, s64, rtol=1e-4, atol=5e-3)


def test_a_zero():
    # a == 0 is the DP case; S^n_m become unsigned Stirling numbers of the
    # first kind.
    ex = exact_logS(Fraction(0), 25)
    t = stirling.make(25, 25, 50, 50, 0.0, dtype=jnp.float64)
    for (n, m) in [(5, 2), (10, 4), (25, 7)]:
        np.testing.assert_allclose(float(t.S(n, m)), ex[(n, m)], atol=1e-11)


def test_tag_in_report_and_bound_errors():
    """S_tag analog: the tag names the table in reports and bound deaths
    (stable.h:137-138; stable.c:105-108, 915-917)."""
    import pytest

    from libstb_jax.utils.yaps import LibstbError

    tab = stirling.make(64, 16, 128, 32, 0.5, tag="doc-topic")
    assert "doc-topic" in tab.report()
    # tag survives remake and growth
    assert stirling.remake(tab, 0.3).tag == "doc-topic"
    assert stirling.ensure(tab, 100, 16).tag == "doc-topic"
    with pytest.raises(LibstbError, match="doc-topic"):
        stirling.ensure(tab, 10_000, 16, quit_on_bound=True)
    with pytest.raises(ValueError, match="untagged"):
        stirling.make(64, 16, 128, 32, 0.5, build_s=False, build_v=False,
                      tag="untagged")
