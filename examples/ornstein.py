"""Fitting an Ornstein-Uhlenbeck process (reference: examples/ornstein.jl).

Uniform priors on (tau, sigma, mu); AR(1)-style residual likelihood; the
model scale hint helps RWM-family samplers (m.scale, reference ornstein.jl:31).
"""
import jax.numpy as jnp
import numpy as np

import mcmc_jl as mc


def make_series(seed=1, duration=1000, mu0=10.0, tau0=20.0, sigma0=0.1):
    rng = np.random.default_rng(seed)
    x = np.empty(duration)
    x[0] = 1.0
    f = np.exp(-1.0 / tau0)
    for i in range(1, duration):
        x[i] = x[i - 1] * f + mu0 * (1 - f) + sigma0 * rng.standard_normal()
    return jnp.asarray(x)


def make_model(x, gradient=True):
    def ex(tau, sigma, mu):
        mc.tilde(tau, mc.Uniform(0.0, 100.0))
        mc.tilde(sigma, mc.Uniform(0.0, 2.0))
        mc.tilde(mu, mc.Uniform(0.0, 20.0))
        fac = jnp.exp(-1.0 / tau)
        resid = x[1:] - x[:-1] * fac - mu * (1.0 - fac)
        mc.tilde(resid, mc.Normal(0.0, sigma))

    m = mc.model(ex, tau=0.05, sigma=1.0, mu=1.0, gradient=gradient)
    # scale hint for tau, sigma and mu, to help sampling (ornstein.jl:31)
    return m.with_scale(jnp.asarray([1000.0, 1.0, 10.0]))


if __name__ == "__main__":
    x = make_series()
    m = make_model(x)

    chain01 = mc.run(m * mc.RAM() * mc.SerialMC(range(1000, 10001)))
    mc.describe(chain01)
    print("RAM acceptance:", mc.acceptance(chain01))

    chain02 = mc.run(m * mc.HMC(5, 0.002) * mc.SerialMC(range(1000, 10001)))
    print("HMC acceptance:", mc.acceptance(chain02))

    chain03 = mc.run(m * mc.NUTS() * mc.SerialMC(range(500, 1001)))
    print("NUTS ndoublings mean:", chain03.diagnostics["ndoublings"].mean())
