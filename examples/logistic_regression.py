"""Bayesian logistic regression, 1000 obs x 10 covariates
(reference: examples/logistic_regression.jl) — the benchmark workload
(BASELINE.md "binomial 10x1000").
"""
import jax
import jax.numpy as jnp
import numpy as np

import mcmc_jl as mc


def make_data(seed=1, n=1000, nbeta=10):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, nbeta - 1))])
    beta0 = rng.standard_normal(nbeta)
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta0))).astype(np.float64)
    return jnp.asarray(X), jnp.asarray(Y), beta0


def make_model(X, Y, nbeta=10, gradient=True):
    def ex(vars):
        mc.tilde(vars, mc.Normal(0.0, 1.0))  # Normal prior
        prob = 1.0 / (1.0 + jnp.exp(-(X @ vars)))
        mc.tilde(Y, mc.Bernoulli(prob))

    return mc.model(ex, vars=np.zeros(nbeta), gradient=gradient)


if __name__ == "__main__":
    X, Y, beta0 = make_data()
    m = make_model(X, Y)

    chain01 = mc.run(m * mc.RWM(0.05) * mc.SerialMC(range(1000, 10001)))
    mc.describe(chain01)

    chain02 = mc.run(m * mc.HMC(2, 0.1) * mc.SerialMC(range(1000, 10001)))
    print("HMC acceptance:", mc.acceptance(chain02))

    chain03 = mc.run(m * mc.NUTS() * mc.SerialMC(range(1000, 10001)))
    print("NUTS var:", mc.var(chain03))
