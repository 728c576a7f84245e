"""The f32 plain fill the GPU runs (``stirling.fill_rows``, vmapped over
the grid by ``agrid.make_grid``) against the f64 fill, and the
``data_curve`` contraction route against its gather route.

Correctness criteria mirror test/precision_test.c's float-vs-double
methodology; the GPU itself runs the same checks at full size in
chip_smoke.py.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libstb_jax.core import agrid, stirling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U32 = 2.0 ** -24


@pytest.fixture(scope="module")
def filled():
    N, M = 160, 48
    grid = agrid.make_grid(N, M, g=8, a_lo=0.0, a_hi=0.9)
    avec = np.asarray(grid.avec)            # the f32 discounts filled
    return avec, N, M, np.asarray(grid.vtab), np.asarray(grid.srel)


def test_grid_v_matches_f64(filled):
    avec, N, M, vt, _ = filled
    for gi, a in enumerate(avec):
        v64, _, _ = stirling.fill_rows(float(a), N, M, dtype=jnp.float64)
        v64 = np.asarray(v64)
        live = np.isfinite(v64) & (v64 > 0)
        np.testing.assert_allclose(vt[gi][live], v64[live], rtol=3e-5,
                                   err_msg=f"a={a}")
        # above-diagonal cells are exactly 0 (masked by V() queries)
        np.testing.assert_array_equal(vt[gi][np.isfinite(v64) & (v64 == 0)],
                                      0.0)


def test_grid_srel_matches_f64(filled):
    avec, N, M, _, sr = filled
    for gi, a in enumerate(avec):
        _, s64, _ = stirling.fill_rows(float(a), N, M, dtype=jnp.float64)
        s64 = np.asarray(s64)
        fin = np.isfinite(s64)
        assert np.max(np.abs(sr[gi][fin] - s64[fin])) < 1e-4, f"a={a}"
        # -inf pattern (m > n) must match exactly
        np.testing.assert_array_equal(np.isneginf(sr[gi]), np.isneginf(s64))


def test_grid_diagonal_is_minus_s1(filled):
    """srel(n, n) = sum_{j=2..n} log V(n, j) = -S1(n): the along-m f32
    cumsum of <= M log terms must hit the exact diagonal identity within
    M*u*|S1| (the worst-case rounding of that sum)."""
    avec, N, M, _, sr = filled
    for gi, a in enumerate(avec):
        s1 = stirling.s1_host(float(a), M)
        diag = np.array([sr[gi][n - 1, n - 1] for n in range(2, M + 1)])
        np.testing.assert_allclose(diag, -s1[1:],
                                   atol=M * U32 * np.abs(s1).max(),
                                   err_msg=f"a={a}")


def test_grid_nosrel_path():
    grid = agrid.make_grid(64, 16, g=4, a_lo=0.3, a_hi=0.6, build_s=False)
    assert grid.srel is None and grid.vtab.shape == (4, 64, 16)
    for gi, a in enumerate(np.asarray(grid.avec)):
        v64, _, _ = stirling.fill_rows(float(a), 64, 16, dtype=jnp.float64)
        v64 = np.asarray(v64)
        live = np.isfinite(v64) & (v64 > 0)
        np.testing.assert_allclose(np.asarray(grid.vtab[gi])[live],
                                   v64[live], rtol=3e-5)


@pytest.mark.parametrize("a,N,M", [
    (0.4321, 200, 64),
    (0.55, 512, 48),
    (0.05, 384, 32),            # small discount
    (0.0, 256, 24),             # a == 0 (DP limit)
])
def test_fill_rows_f32_matches_f64(a, N, M):
    """The single-table f32 fill (stirling.make's route) against f64.
    V's f32 relative error grows with n (about n*u at worst, see
    chip_smoke.v_tol); for n <= 512 that is the 3e-5 used here."""
    vt, sr, _ = stirling.fill_rows(a, N, M, dtype=jnp.float32)
    vt, sr = np.asarray(vt), np.asarray(sr)
    v64, s64, _ = stirling.fill_rows(a, N, M, dtype=jnp.float64)
    v64, s64 = np.asarray(v64), np.asarray(s64)
    fin = np.isfinite(v64) & (v64 != 0)
    np.testing.assert_allclose(vt[fin], v64[fin], rtol=3e-5,
                               err_msg=f"a={a}")
    finS = np.isfinite(s64)
    err = np.abs(sr[finS] - s64[finS]) / np.maximum(1.0, np.abs(s64[finS]))
    assert np.max(err) < 1e-4, f"a={a}"
    # above-diagonal cells: V == 0 exactly, srel -inf
    above = ~np.isfinite(s64)
    np.testing.assert_array_equal(vt[above], 0.0)
    assert np.all(np.isneginf(sr[above]))


@pytest.fixture(scope="module")
def grid32():
    return agrid.make_grid(300, 40, g=16, a_lo=0.0, a_hi=0.99)


@pytest.mark.parametrize("gi", [1, 5, 10, 14])
def test_grid_table_equals_make(grid32, gi):
    """Grid table g is stirling.make's table at the same f32 discount:
    both are fill_rows, vmapped over the grid or not."""
    a = float(np.asarray(grid32.avec)[gi])
    tab = stirling.make(300, 40, 300, 40, a)
    np.testing.assert_array_equal(np.asarray(grid32.vtab[gi]),
                                  np.asarray(tab.vtab))
    np.testing.assert_array_equal(np.asarray(grid32.srel[gi]),
                                  np.asarray(tab.srel))


def _curve_terms(grid, ns, ts):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke.curve_terms(grid, ns, ts)


@pytest.mark.parametrize("C,P,M", [(16, 40, 64), (64, 80, 128),
                                   (32, 24, 512)])
def test_data_curve_mm_matches_gather_f32(C, P, M):
    """The contraction route of data_curve sums the same f32 terms as the
    gather route in another order: they agree within 2 (P-1) u sum|terms|
    (the worst-case rounding of two P-term sums)."""
    rng = np.random.default_rng(C + P + M)
    grid = agrid.make_grid(M, M, g=32)
    ns = rng.integers(0, M + 1, P).astype(np.int32)
    ts = np.floor(rng.uniform(0, 1, (C, P)) * (ns + 1)).astype(np.int32)
    mm = np.asarray(grid._data_curve_mm(jnp.asarray(ns), jnp.asarray(ts)),
                    np.float64)
    ga = np.asarray(grid._data_curve_gather(jnp.asarray(ns),
                                            jnp.asarray(ts)), np.float64)
    terms = _curve_terms(grid, ns, ts).astype(np.float64)
    scale = np.moveaxis(np.abs(terms).sum(-1), 0, -1)
    exact = np.moveaxis(terms.sum(-1), 0, -1)
    tol = (P - 1) * U32 * np.maximum(scale, 1e-30)
    assert np.all(np.abs(mm - exact) <= tol)
    assert np.all(np.abs(ga - exact) <= tol)
    assert np.all(np.abs(mm - ga) <= 2 * tol)


def test_data_curve_mm_contracts_at_highest_precision():
    """A default-precision f32 product may run in TF32 on the GPU and
    round each log-S term to ~3 digits; the contraction asks for HIGHEST."""
    grid = agrid.make_grid(32, 16, g=8)
    jaxpr = jax.make_jaxpr(grid._data_curve_mm)(
        jnp.asarray([3, 5]), jnp.asarray([[1, 2], [2, 4]]))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec
