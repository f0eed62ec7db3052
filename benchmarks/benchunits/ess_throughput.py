"""Effective-sample throughput unit (the BASELINE.json "ESS/sec" metric).

Runs the 3-D standard-normal HMC config of the README baseline across a
vmapped chain batch and reports min-coordinate ESS per second, pooled over
chains — the statistically-meaningful throughput (raw steps/s x ESS/step).
"""
import time

import numpy as np


def run():
    import jax
    import jax.numpy as jnp

    import mcmc_jl as mc
    from mcmc_jl.parallel import run_chains
    from mcmc_jl.stats.var import mcvar_iid, mcvar_imse

    model = mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v,
                     init=jnp.ones(3), check_init=False)
    sampler = mc.HMC(0.75)  # README config: 10 leaps, eps=0.75
    n_chains, steps, burnin = 64, 2000, 500
    runner = mc.SerialMC(steps=steps, burnin=burnin)

    infos, _, _ = run_chains(model, sampler, runner, n_chains, seed=0, jitter=0.5)
    jax.block_until_ready(infos["plogtarget"])
    t0 = time.perf_counter()
    infos, _, _ = run_chains(model, sampler, runner, n_chains, seed=1, jitter=0.5)
    x = np.asarray(infos["ppars"])[burnin:]  # (kept, chains, 3)
    dt = time.perf_counter() - t0

    kept = x.shape[0]
    ess_per_chain = np.empty((n_chains, 3))
    for c in range(n_chains):
        ess_per_chain[c] = kept * mcvar_iid(x[:, c]) / mcvar_imse(x[:, c])
    total_min_ess = ess_per_chain.min(axis=1).sum()
    acc = 100.0 * np.mean(np.asarray(infos["accept"]))

    return [
        ("normal3d HMC(0.75): acceptance %", acc, "%"),
        ("normal3d HMC(0.75): pooled min-coord ESS/s", total_min_ess / dt, "ESS/s"),
        ("normal3d HMC(0.75): mean ESS per chain (of kept)",
         ess_per_chain.mean(), "samples"),
    ]
