"""Poisson regression with exposure offsets via the GLM fast path.

Counts with unequal exposure windows: y_i ~ Poisson(E_i * exp(x_i' beta)),
i.e. a log-link GLM with offset log(E_i) — the canonical use of
``model(glm=..., offsets=...)``.  The same model object runs on every
sampler; on a GPU, ``run(..., chains=N, fused=True)`` runs plain HMC
through the Triton trajectory kernel (``fused="auto"`` keeps the poisson
link on XLA: the kernel was timed only on the logistic link).

(The reference has no GLM front end; its closest workload is the logistic
example, examples/logistic_regression.jl.)
"""
import numpy as np

import mcmc_jl as mc


def make_data(n=400, seed=7):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, 2))])
    beta = np.array([0.4, 0.8, -0.5])
    exposure = rng.uniform(0.5, 4.0, n)  # observation windows
    lam = exposure * np.exp(X @ beta)
    Y = rng.poisson(lam).astype(np.float64)
    return X, Y, np.log(exposure), beta


def make_model(X, Y, log_exposure):
    return mc.model(glm=("poisson", X, Y), offsets=log_exposure,
                    prior_prec=0.01)


def main():
    X, Y, log_e, beta_true = make_data()
    m = make_model(X, Y, log_e)

    chain = mc.run(m * mc.NUTS(mass_adapt="dense")
                   * mc.SerialMC(steps=3000, burnin=1000), seed=0)
    est = chain.samples.values.mean(axis=0)
    se = np.sqrt(mc.var(chain))
    print("acceptance %:", mc.acceptance(chain))
    for i, (b, e, s) in enumerate(zip(beta_true, est, se)):
        print(f"beta[{i}]: true {b:+.3f}  posterior {e:+.3f} +- {s:.4f}")
    mc.describe(chain)


if __name__ == "__main__":
    main()
