"""Linear regression, 1000 obs x 10 covariates
(reference: examples/linear_regression.jl).

Model: Normal prior on coefficients, Gaussian residuals; run RWM without and
RAM with adaptation, compare posterior mean against the generating betas.
"""
import jax
import jax.numpy as jnp
import numpy as np

import mcmc_jl as mc

# simulate dataset
rng = np.random.default_rng(1)
n, nbeta = 1000, 10
X = jnp.asarray(np.column_stack([np.ones(n), rng.standard_normal((n, nbeta - 1))]))
beta0 = rng.standard_normal(nbeta)
Y = jnp.asarray(X @ beta0 + rng.standard_normal(n))


# define model (the reference's quote block, as a tilde-DSL function)
def ex(vars):
    mc.tilde(vars, mc.Normal(0.0, 1.0))  # Normal prior, std 1.0
    resid = Y - X @ vars
    mc.tilde(resid, mc.Normal(0.0, 1.0))


m = mc.model(ex, vars=np.zeros(nbeta))

if __name__ == "__main__":
    # random-walk metropolis, thinning 10, no adaptation
    chain01 = mc.run(m * mc.RWM(0.05) * mc.SerialMC(range(10000, 100001, 10)))
    print("RWM acceptance:", mc.acceptance(chain01))  # ~ 3%, too low

    # with adaptation (target acceptance = 30%)
    chain02 = mc.run(m * mc.RAM(1.0, 0.3) * mc.SerialMC(range(10000, 100001, 10)))
    print("RAM acceptance:", mc.acceptance(chain02))  # ~ 30%

    print("posterior mean vs original coefs:")
    print(np.column_stack([mc.mean(chain02), beta0]))
