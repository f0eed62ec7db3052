"""Adaptive HMC on many chains: a warm start, then a frozen sampling phase.

The realistic production run — tuner step-size adaptation plus a diagonal
mass metric during burn-in, then a long sampling phase at the frozen
hyper-parameters — goes through ``run(task, chains=N)`` on the generic
vmapped engine: every chain adapts during burn-in (reference
samplers.jl:31-50), the adaptation freezes at the end of burn-in, and the
chains come back with the standard protocol (exact resume included).
"""
import numpy as np

import mcmc_jl as mc


def make_data(n=1000, nbeta=10, seed=1):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, nbeta - 1))])
    beta0 = rng.standard_normal(nbeta)
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta0))).astype(np.float64)
    return X, Y, beta0


def main(n=1000, nbeta=10, chains=8, steps=2000, burnin=500):
    X, Y, beta0 = make_data(n, nbeta)
    model = mc.model(glm=("logistic", X, Y))

    # EmpMCTuner adapts the step size toward 80% acceptance during burn-in
    # (reference samplers.jl:31-50); mass_adapt="diag" adds a Welford
    # diagonal metric (beyond-reference).  Both freeze at the end of
    # burn-in.
    sampler = mc.HMC(10, 0.02, mc.EmpMCTuner(0.8, adapt_step=50),
                     mass_adapt="diag")
    task = model * sampler * mc.SerialMC(steps=steps, burnin=burnin)

    chains_out = mc.run(task, chains=chains, seed=0)
    acc = np.mean([mc.acceptance(c) for c in chains_out])
    ess = np.mean([np.mean(mc.ess(c)) for c in chains_out])
    print(f"acceptance {acc:.1f}%  mean ESS {ess:.0f} per chain")

    pooled = np.mean([c.samples.values.mean(0) for c in chains_out], axis=0)
    print("posterior mean (first 4):", np.round(pooled[:4], 3))
    print("truth          (first 4):", np.round(beta0[:4], 3))

    # exact resume at the frozen hyper-parameters
    more = mc.resume(chains_out[0], steps=200)
    print("resumed rows:", more.samples.shape[0])
    return chains_out


if __name__ == "__main__":
    main()
