"""ESS-per-gradient of the integrator family (samplers/integrators.py).

Matched gradient budget per transition (~24 gradients): leapfrog takes 24
steps of eps, the k-stage BCSS schemes take 24/k steps of k*eps.  Metric:
pooled min-coordinate ESS per 1k gradient evaluations on the correlated
3-D Gaussian — the quantity multi-stage integrators are built to raise.
"""
import numpy as np


def run():
    import jax.numpy as jnp

    import mcmc_jl as mc
    from mcmc_jl.parallel import run_chains
    from mcmc_jl.stats.var import mcvar_iid, mcvar_imse

    A = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, 0.2], [0.0, 0.2, 0.5]])
    Aj = jnp.asarray(A)
    model = mc.model(lambda v: -0.5 * v @ Aj @ v, gradient=True,
                     init=jnp.ones(3), check_init=False)

    n_chains, steps, burnin = 32, 2000, 500
    # near leapfrog's stability edge — where the error constant matters
    eps, budget = 0.6, 24
    rows = []
    for name, k in [("leapfrog", 1), ("2stage", 2), ("3stage", 3)]:
        sampler = mc.HMC(budget // k, eps * k, integrator=name)
        runner = mc.SerialMC(steps=steps, burnin=burnin)
        infos, _, _ = run_chains(model, sampler, runner, n_chains, seed=0,
                                 jitter=0.5)
        x = np.asarray(infos["ppars"])[burnin:]  # (kept, chains, 3)
        kept = x.shape[0]
        ess = np.empty((n_chains, 3))
        for c in range(n_chains):
            ess[c] = kept * mcvar_iid(x[:, c]) / mcvar_imse(x[:, c])
        grads = kept * budget  # per chain
        acc = 100.0 * np.mean(np.asarray(infos["accept"])[burnin:])
        rows.append((f"corr3d HMC {name}: min-coord ESS / 1k grads",
                     1000.0 * ess.min(axis=1).mean() / grads, "ESS/kgrad"))
        rows.append((f"corr3d HMC {name}: acceptance %", acc, "%"))
    return rows
