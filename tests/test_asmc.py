"""Adaptive annealed SMC (runners/asmc.py): posterior correctness, adaptive
schedule behavior, and the SMC logZ estimate against an analytic evidence
(cross-validating the PTMC TI/stepping-stone estimators)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mcmc_jl as mc

L2PI = np.log(2 * np.pi)


def _conjugate(n=20, seed=3):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(n) + 0.7
    sy, yy = y.sum(), (y * y).sum()
    logz = -n / 2 * L2PI - 0.5 * np.log(1.0 + n) \
        - 0.5 * (yy - sy ** 2 / (1.0 + n))
    yd = jnp.asarray(y)

    def logprior(th):
        return -0.5 * th[0] ** 2 - 0.5 * L2PI

    def logp(th):
        return -0.5 * jnp.sum((yd - th[0]) ** 2) - n / 2 * L2PI + logprior(th)

    def prior_sample(key):
        return jax.random.normal(key, (1,))

    post_mean = sy / (n + 1.0)
    post_sd = 1.0 / np.sqrt(n + 1.0)
    return logp, logprior, prior_sample, float(logz), post_mean, post_sd


def test_asmc_conjugate_logz_and_posterior():
    logp, logprior, prior_sample, logz, mu, sd = _conjugate()
    m = mc.model(logp, gradient=True, init=jnp.zeros(1))
    runner = mc.ASMC(particles=2048, target_ess=0.5, moves=3,
                     logprior=logprior, prior_sample=prior_sample)
    chain = mc.run(m * mc.RWM(0.5) * runner, seed=0)
    d = chain.diagnostics
    assert abs(d["logz"] - logz) < 0.25, (d["logz"], logz)
    x = chain.samples.values[:, 0]
    assert abs(x.mean() - mu) < 4 * sd / np.sqrt(200)  # ESS >= ~200 of 2048
    assert abs(x.std(ddof=1) - sd) < 0.25 * sd
    # adaptive schedule: strictly increasing to exactly 1, ESS near target
    b = d["betas"]
    assert b[-1] == pytest.approx(1.0)
    assert np.all(np.diff(np.concatenate([[0.0], b])) > 0)
    assert d["n_stages"] >= 2
    # every non-final stage hit the ESS target by construction
    assert np.all(d["ess"][:-1] < 0.6 * 2048)


def test_asmc_hmc_moves_match_rwm():
    """Gradient rejuvenation kernel through the same prior-tempered view."""
    logp, logprior, prior_sample, logz, mu, sd = _conjugate()
    m = mc.model(logp, gradient=True, init=jnp.zeros(1))
    runner = mc.ASMC(particles=1024, target_ess=0.5, moves=2,
                     logprior=logprior, prior_sample=prior_sample)
    chain = mc.run(m * mc.HMC(5, 0.3) * runner, seed=1)
    assert abs(chain.diagnostics["logz"] - logz) < 0.3
    x = chain.samples.values[:, 0]
    assert abs(x.mean() - mu) < 0.1
    assert np.mean(chain.diagnostics["accept"]) > 0.5


def test_asmc_bimodal_keeps_both_modes():
    """Annealing from a broad prior populates both modes where a cold chain
    would stick in one — the tempering capability gate, SMC flavor."""
    st = 0.35

    def logprior(v):
        return -0.5 * v[0] ** 2 / 36.0 - 0.5 * np.log(2 * np.pi * 36.0)

    def logp(v):
        ll = jnp.logaddexp(mc.Normal(-4.0, st).logpdf(v[0]),
                           mc.Normal(4.0, st).logpdf(v[0])) - np.log(2.0)
        return ll + logprior(v)

    m = mc.model(logp, gradient=True, init=jnp.zeros(1))
    runner = mc.ASMC(particles=2048, target_ess=0.6, moves=3,
                     logprior=logprior,
                     prior_sample=lambda k: 6.0 * jax.random.normal(k, (1,)))
    chain = mc.run(m * mc.RWM(0.4) * runner, seed=2)
    x = chain.samples.values[:, 0]
    frac_left = np.mean(x < 0)
    assert 0.3 < frac_left < 0.7, frac_left


def test_asmc_validation():
    with pytest.raises(AssertionError):
        mc.ASMC(logprior=None, prior_sample=lambda k: 0.0)
    with pytest.raises(AssertionError):
        mc.ASMC(logprior=lambda t: 0.0, prior_sample=None)


def test_asmc_sharded_over_mesh():
    """Particle axis sharded over the virtual 8-device mesh: same gates
    (logZ, posterior moments) through the collective-inserting path."""
    from mcmc_jl.parallel.sharded import make_mesh

    logp, logprior, prior_sample, logz, mu, sd = _conjugate()
    m = mc.model(logp, gradient=True, init=jnp.zeros(1))
    mesh = make_mesh(8, 1)
    runner = mc.ASMC(particles=2048, target_ess=0.5, moves=2,
                     logprior=logprior, prior_sample=prior_sample)
    chain = mc.run(m * mc.RWM(0.5) * runner, seed=3, mesh=mesh)
    assert abs(chain.diagnostics["logz"] - logz) < 0.3
    x = chain.samples.values[:, 0]
    assert abs(x.mean() - mu) < 0.1


def test_asmc_resume_rejuvenates_at_full_posterior():
    """resume() on an ASMC chain runs more MCMC moves at beta=1 on the
    stored final ensemble; posterior moments are preserved and the
    continuation is deterministic in the task."""
    logp, logprior, prior_sample, logz, post_mean, post_sd = _conjugate()
    m = mc.model(logp, gradient=True, init=jnp.zeros(1), check_init=False)
    r = mc.ASMC(particles=512, logprior=logprior, prior_sample=prior_sample)
    c = mc.run(m * mc.RWM(0.5) * r, seed=0)
    assert c.task.state is not None and c.task.state.shape == (512, 1)

    c2 = mc.resume(c, steps=20)
    x = c2.samples.values[:, 0]
    assert abs(x.mean() - post_mean) < 6 * post_sd / np.sqrt(100) + 0.05
    assert abs(x.std() - post_sd) < 0.1
    assert c2.diagnostics["accept"] > 0.1
    c3 = mc.resume(c, steps=20)
    np.testing.assert_array_equal(c2.samples.values, c3.samples.values)
    # and the resumed chain resumes again (state carried forward)
    c4 = mc.resume(c2, steps=5)
    assert np.all(np.isfinite(c4.samples.values))
