"""ARS/ARMS sampler: distributional correctness on known targets
(the methodology of check.c's multi-sampler agreement, SURVEY.md §4.4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libstb_jax.samplers import ars


def _moments(x):
    x = np.asarray(x)
    return x.mean(), x.std()


def test_truncated_normal():
    C = 4096
    logp = lambda x: -0.5 * x * x
    key = jax.random.key(0)
    x, ok = ars.ars_sample(logp, key, jnp.full((C,), -6.0),
                           jnp.full((C,), 6.0))
    assert np.asarray(ok).all()
    m, s = _moments(x)
    # one ARS draw per chain, C chains: SE(mean) ~ 1/sqrt(C)
    assert abs(m) < 5 / np.sqrt(C)
    assert abs(s - 1.0) < 0.05


def test_gamma_target():
    # Gamma(5, 1) on (0, 50): mean 5, var 5
    C = 4096
    logp = lambda x: 4.0 * jnp.log(x) - x
    x, ok = ars.ars_sample(logp, jax.random.key(1),
                           jnp.full((C,), 1e-3), jnp.full((C,), 50.0))
    assert np.asarray(ok).all()
    m, s = _moments(x)
    assert abs(m - 5.0) < 0.2
    assert abs(s - np.sqrt(5.0)) < 0.2


def test_skewed_exponential():
    # Exp(1) truncated to (0, 20)
    C = 4096
    logp = lambda x: -x
    x, ok = ars.ars_sample(logp, jax.random.key(2),
                           jnp.full((C,), 1e-4), jnp.full((C,), 20.0))
    assert np.asarray(ok).all()
    m, _ = _moments(x)
    assert abs(m - 1.0) < 0.1


def test_heterogeneous_chains():
    # each chain targets N(mu_c, 1): verified per-chain
    C = 1024
    mus = jnp.linspace(-3.0, 3.0, C)
    logp = lambda x: -0.5 * (x - mus) ** 2
    x, ok = ars.ars_sample(logp, jax.random.key(3),
                           jnp.full((C,), -12.0), jnp.full((C,), 12.0))
    assert np.asarray(ok).all()
    resid = np.asarray(x) - np.asarray(mus)
    assert abs(resid.mean()) < 0.2
    assert abs(resid.std() - 1.0) < 0.1


def test_metropolis_bimodal():
    """ARMS mode on a non-log-concave (bimodal) target stays exact as an
    MCMC kernel: run a short chain per walker and check the mode weights."""
    C = 2048
    logp = lambda x: jnp.logaddexp(-0.5 * (x - 2.0) ** 2 / 0.25,
                                   jnp.log(3.0) - 0.5 * (x + 2.0) ** 2 / 0.25)
    key = jax.random.key(4)
    x = jnp.zeros((C,))
    for i in range(20):
        key, k = jax.random.split(key)
        x, ok = ars.ars_sample(logp, k, jnp.full((C,), -8.0),
                               jnp.full((C,), 8.0), x_prev=x,
                               metropolis=True)
    frac_neg = float((np.asarray(x) < 0).mean())
    assert abs(frac_neg - 0.75) < 0.08


def test_reject_cap_reported():
    # an adversarial spike the envelope cannot cover quickly still
    # terminates and reports ok correctly
    C = 64
    logp = lambda x: jnp.where(jnp.abs(x - 0.123456) < 1e-4, 0.0, -200.0)
    x, ok = ars.ars_sample(logp, jax.random.key(5),
                           jnp.full((C,), -1.0), jnp.full((C,), 1.0),
                           max_rejects=5)
    assert x.shape == (C,)  # no crash; ok may be False (err 2001 analog)


def test_neval_telemetry():
    """with_info returns the per-chain density-evaluation count (the
    arms.c:24,151 neval diagnostic): n_init + 1 baseline, plus one per
    rejection round, and never above n_init + 1 + max_rejects."""
    C = 64
    mu = jnp.linspace(-1.0, 1.0, C)

    def logpost(x):
        return -0.5 * (x - mu) ** 2

    x, ok, nev = ars.ars_sample(logpost, jax.random.key(0),
                                jnp.full((C,), -5.0), jnp.full((C,), 5.0),
                                n_init=5, with_info=True)
    nev = np.asarray(nev)
    assert np.asarray(ok).all()
    assert (nev >= 5 + 1 + 1).all()          # at least one env draw
    assert (nev <= 5 + 1 + ars.MAX_REJECTS).all()
    # a well-matched envelope needs FEW evals (the efficiency the
    # reference's telemetry is for)
    assert nev.mean() < 20
