"""Marginal-likelihood estimation (stats/evidence.py) on prior-tempered
PTMC ladders — validated against the analytic evidence of a conjugate
Gaussian model.  (No reference equivalent; capability beyond
dingliumath/MCMC.jl.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mcmc_jl as mc

L2PI = np.log(2 * np.pi)


def _conjugate(n=20, seed=3):
    """y_i ~ N(theta, 1), theta ~ N(0, 1): logZ analytic via
    y ~ MVN(0, I + 11^T) and Sherman-Morrison."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(n) + 0.7
    sy, yy = y.sum(), (y * y).sum()
    logz = -n / 2 * L2PI - 0.5 * np.log(1.0 + n) \
        - 0.5 * (yy - sy ** 2 / (1.0 + n))
    yd = jnp.asarray(y)

    def logprior(th):
        return -0.5 * th[0] ** 2 - 0.5 * L2PI

    def logp(th):
        ll = -0.5 * jnp.sum((yd - th[0]) ** 2) - n / 2 * L2PI
        return ll + logprior(th)

    return logp, logprior, float(logz)


BETAS = tuple(float((k / 7) ** 5) for k in range(8))  # 0 ... 1, beta^5 ladder


def _run(sampler, steps=4000, seed=0, **kw):
    logp, logprior, logz = _conjugate()
    m = mc.model(logp, gradient=True, init=jnp.zeros(1), check_init=True)
    runner = mc.PTMC(steps=steps, burnin=500, swap_period=5, betas=BETAS,
                     logprior=logprior, **kw)
    chain = mc.run(m * sampler * runner, seed=seed)
    return chain, logz


def test_logz_rwm():
    chain, logz = _run(mc.RWM(0.8))
    est_ti = mc.logz_ti(chain, burnin=500)
    est_ss = mc.logz_ss(chain, burnin=500)
    assert abs(est_ti - logz) < 0.35, (est_ti, logz)
    assert abs(est_ss - logz) < 0.25, (est_ss, logz)


def test_logz_hmc_grad_swap_path():
    """Gradient sampler exercises the grad-cache rescaling across swaps,
    including the beta=0 rung's fresh likelihood gradient."""
    chain, logz = _run(mc.HMC(5, 0.3), seed=1)
    est_ti = mc.logz_ti(chain, burnin=500)
    est_ss = mc.logz_ss(chain, burnin=500)
    assert abs(est_ti - logz) < 0.35, (est_ti, logz)
    assert abs(est_ss - logz) < 0.25, (est_ss, logz)
    # cold rung still samples the true posterior: theta | y ~ N(sy/(n+1), 1/(n+1))
    x = chain.samples.values[:, 0]
    assert abs(x.std(ddof=1) - 1 / np.sqrt(21)) < 0.05


def test_prior_tempered_swaps_preserve_posterior():
    chain, _ = _run(mc.RWM(0.8), seed=2)
    assert chain.diagnostics["nswaps"].sum() > 50
    ll = chain.diagnostics["replica_ll"]
    assert ll.shape == (4000, len(BETAS))
    # rung means of log-lik must be increasing in beta (power-posterior
    # concentration onto the likelihood)
    m = ll[500:].mean(axis=0)
    assert np.all(np.diff(m) > -0.5), m


def test_validation():
    with pytest.raises(AssertionError):
        mc.PTMC(betas=(0.0, 0.5, 1.0))  # beta=0 without logprior
    # stepping-stone demands prior draws
    with pytest.raises(ValueError):
        mc.logz_ss(np.zeros((10, 3)), betas=np.array([0.1, 0.5, 1.0]))
    # raw-array API
    ll = np.zeros((100, 3))
    assert mc.logz_ti(ll, betas=np.array([0.0, 0.5, 1.0])) == 0.0
