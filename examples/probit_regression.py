"""Bayesian probit regression with user-supplied gradient, metric tensor and
tensor derivatives (reference: examples/probit_regression.jl) — the manifold-
sampler workload (SMMALA / PMALA / RMHMC need tensor/dtensor).

Loads the reference's own 39-row vaso dataset (examples/vaso.txt, vendored
verbatim — it is the reference's test fixture, probit_regression.jl:7-16);
``path=False`` synthesizes an equivalent 2-covariate binary dataset instead.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np

import mcmc_jl as mc
from jax.scipy import special as jsp

LOG2PI = np.log(2 * np.pi)
VASO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vaso.txt")


def make_data(seed=3, n=39, path=VASO):
    if path:
        raw = np.loadtxt(path)
        covariates, y = raw[:, :-1], raw[:, -1]
    else:
        from scipy.special import ndtr

        rng = np.random.default_rng(seed)
        covariates = rng.standard_normal((n, 2)) * [1.0, 1.0] + [1.3, 1.7]
        z = 0.8 * covariates[:, 0] - 0.5 * covariates[:, 1] + 0.3
        y = (rng.random(n) < ndtr(z)).astype(float)
    nsamples, npars = covariates.shape
    covariates = (covariates - covariates.mean(0)) / covariates.std(0, ddof=1)
    X = np.column_stack([np.ones(nsamples), covariates])
    return jnp.asarray(X), jnp.asarray(y)


def make_model(X, y, priorstd=10.0, seed=0):
    npars = X.shape[1]
    priorvar = priorstd**2

    def logcdfn(z):
        return jsp.log_ndtr(z)

    def log_posterior(pars):
        XPars = X @ pars
        loglik = jnp.dot(logcdfn(XPars), y) + jnp.dot(logcdfn(-XPars), 1.0 - y)
        logprior = -0.5 * jnp.dot(pars, pars) / priorvar - 0.5 * npars * (
            LOG2PI + 2 * jnp.log(priorstd)
        )
        return loglik + logprior

    # analytic derivatives, mirroring the reference's closed forms
    # (probit_regression.jl:36-67)
    def grad_log_posterior(pars):
        XPars = X @ pars
        t = jnp.exp(-(XPars**2 + LOG2PI) / 2.0)
        v = y * t * jnp.exp(-logcdfn(XPars)) - (1.0 - y) * t * jnp.exp(-logcdfn(-XPars))
        return X.T @ v - pars / priorvar

    def tensor(pars):
        XPars = X @ pars
        vec = jnp.exp(-XPars**2 - logcdfn(XPars) - logcdfn(-XPars) - LOG2PI)
        return (X.T * vec) @ X + jnp.eye(npars) / priorvar

    def deriv_tensor(pars):
        XPars = X @ pars
        phi = jnp.exp(-(XPars**2 + LOG2PI) / 2.0)
        Phi = jnp.exp(logcdfn(XPars))
        v01 = jnp.exp(-XPars**2 - 2 * logcdfn(XPars) - logcdfn(-XPars) - LOG2PI)
        cols = []
        for i in range(npars):
            v02 = (
                v01
                * (jnp.exp(-(XPars**2 + LOG2PI) / 2.0 - logcdfn(-XPars))
                   - 2.0 * (phi + XPars * Phi))
                * X[:, i]
            )
            cols.append((X.T * v02) @ X)
        return jnp.stack(cols, axis=-1)  # (npars, npars, npars), dG[:, :, i]

    rng = np.random.default_rng(seed)
    init = rng.standard_normal(npars) * priorstd * 0.1
    return mc.model(
        log_posterior,
        grad=grad_log_posterior,
        tensor=tensor,
        dtensor=deriv_tensor,
        init=jnp.asarray(init),
    )


if __name__ == "__main__":
    X, y = make_data()
    m = make_model(X, y)

    chain01 = mc.run(m * mc.RWM(0.5) * mc.SerialMC(range(1001, 10001)))
    print("RWM acceptance:", mc.acceptance(chain01))

    chain02 = mc.run(m * mc.HMC(0.1) * mc.SerialMC(range(1001, 10001)))
    print("HMC acceptance:", mc.acceptance(chain02))

    chain03 = mc.run(
        m * mc.SMMALA(0.5) * mc.SerialMC(range(1001, 10001))
    )
    print("SMMALA acceptance:", mc.acceptance(chain03))

    chain04 = mc.run(
        m * mc.RMHMC(0.5, mc.EmpMCTuner(0.8, verbose=True)) * mc.SerialMC(range(5001, 10001))
    )
    print("RMHMC acceptance:", mc.acceptance(chain04))
