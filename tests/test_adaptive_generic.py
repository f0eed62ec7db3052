"""Adaptive samplers through run(task, chains=N) on the generic engine.

Every adaptive run takes the generic vmapped engine: each chain adapts
during burn-in, the adaptation freezes after it, and the chains resume
exactly from their stored states.  The moment gates compare the pooled
draws with the analytic posterior of a linear-link model(glm=...) (a
Gaussian posterior) and of a correlated Gaussian written as a plain
log-density."""
import jax.numpy as jnp
import numpy as np
import pytest

import mcmc_jl as mc

SAMPLERS = {
    "hmc_tuned_diag": lambda: mc.HMC(5, 0.05, mc.EmpMCTuner(0.8,
                                                            adapt_step=50),
                                     mass_adapt="diag"),
    "hmcda": lambda: mc.HMCDA(rate=0.7, len=1.0),
    "hmcda_dense": lambda: mc.HMCDA(rate=0.7, len=1.0, mass_adapt="dense"),
    "chees": lambda: mc.ChEESHMC(len0=0.5, max_leaps=16),
    "nuts": lambda: mc.NUTS(maxdoublings=5),
}


def _glm_target():
    rng = np.random.default_rng(4)
    n, d = 60, 3
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    Y = X @ np.array([0.5, -1.0, 0.3]) + rng.standard_normal(n)
    P = X.T @ X + np.eye(d)
    cov = np.linalg.inv(P)
    return mc.model(glm=("linear", X, Y)), cov @ X.T @ Y, cov


def _gauss_target():
    sd = np.array([2.0, 0.5, 1.0])
    corr = np.array([[1.0, 0.6, 0.0], [0.6, 1.0, -0.3], [0.0, -0.3, 1.0]])
    cov = corr * np.outer(sd, sd)
    mu = np.array([1.0, -2.0, 0.5])
    prec = jnp.asarray(np.linalg.inv(cov))
    muj = jnp.asarray(mu)
    m = mc.model(lambda v: -0.5 * (v - muj) @ prec @ (v - muj),
                 gradient=True, init=jnp.zeros(3))
    return m, mu, cov


TARGETS = {"glm": _glm_target, "gauss": _gauss_target}


def _run(target, sampler, steps=1500, burnin=500, chains=8, seed=0):
    model, mu, cov = TARGETS[target]()
    task = model * SAMPLERS[sampler]() * mc.SerialMC(steps=steps,
                                                     burnin=burnin)
    return mc.run(task, chains=chains, seed=seed), mu, cov


@pytest.mark.parametrize("target", list(TARGETS))
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_adaptive_moments(sampler, target):
    chains, mu, cov = _run(target, sampler)
    x = np.concatenate([c.samples.values for c in chains])
    ess = np.sum([mc.ess(c) for c in chains], axis=0)
    sd = np.sqrt(np.diag(cov))
    se = sd / np.sqrt(np.maximum(ess, 10.0))
    assert np.all(np.abs(x.mean(0) - mu) < 5 * se + 0.02 * sd), (
        x.mean(0), mu, se)
    np.testing.assert_allclose(x.std(0), sd, rtol=0.15)
    assert np.all(np.isfinite([c.diagnostics["logtarget"] for c in chains]))


#: the adapted step size of each state type; NUTS keeps the reference's
#: NADAPT = 1000 dual-averaging window (NUTS.jl:121-125), longer than
#: these burn-ins, so only its stored position is checked
FROZEN = {"hmc_tuned_diag": lambda s: s.tune.step_size,
          "hmcda": lambda s: s.dual_leap_step,
          "hmcda_dense": lambda s: s.dual_leap_step,
          "chees": lambda s: s.log_len}


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_adaptive_resume_is_exact(sampler):
    """Resume starts at each chain's stored state with the adapted
    hyper-parameters frozen, and two resumes draw different streams."""
    chains, _, _ = _run("gauss", sampler, steps=600, burnin=300, chains=4)
    more = mc.resume(chains, steps=100)
    again = mc.resume(more, steps=100)
    for c0, c1 in zip(chains, more):
        s0, s1 = c0.task.state, c1.task.state
        np.testing.assert_allclose(np.asarray(s0.pars),
                                   c0.samples.values[-1], rtol=1e-12)
        if sampler in FROZEN:
            np.testing.assert_allclose(np.asarray(FROZEN[sampler](s1)),
                                       np.asarray(FROZEN[sampler](s0)))
        assert c1.task.pos == c0.task.pos + 100
        assert np.all(np.isfinite(c1.samples.values))
    assert not np.allclose(more[0].samples.values, again[0].samples.values)
