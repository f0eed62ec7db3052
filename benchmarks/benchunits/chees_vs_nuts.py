"""ChEES-HMC vs NUTS on the headline logistic-regression posterior.

The point of ChEES (samplers/chees.py) is SIMD shape: NUTS pays for the
deepest tree in the vmapped batch every step, while ChEES chains all run the
same shared-length trajectory.  This unit measures both samplers' wall-clock
transition rate, pooled min-coordinate ESS/s, and ESS per gradient
evaluation (gradients = 2^ndoublings per NUTS transition, `nleaps` per
ChEES transition) at matched step budgets.
"""
import time

import numpy as np


def _logistic_model(n=1000, nbeta=10):
    import jax.numpy as jnp

    import mcmc_jl as mc

    rng = np.random.default_rng(1)
    Xh = np.column_stack([np.ones(n), rng.standard_normal((n, nbeta - 1))])
    beta0 = rng.standard_normal(nbeta)
    Yh = (rng.random(n) < 1.0 / (1.0 + np.exp(-Xh @ beta0))).astype(float)
    X, Y = jnp.asarray(Xh), jnp.asarray(Yh)

    def logp(theta):
        logits = X @ theta
        return (jnp.dot(Y, logits) - jnp.sum(jnp.logaddexp(0.0, logits))
                - 0.5 * jnp.dot(theta, theta))

    return mc.model(logp, gradient=True, init=jnp.zeros(nbeta),
                    check_init=False)


def _min_ess_pooled(x):
    from mcmc_jl.stats.var import mcvar_iid, mcvar_imse

    kept, n_chains, d = x.shape
    tot = 0.0
    for c in range(n_chains):
        tot += float(np.min(kept * mcvar_iid(x[:, c]) / mcvar_imse(x[:, c])))
    return tot


def run():
    import jax

    import mcmc_jl as mc
    from mcmc_jl.parallel import run_chains

    model = _logistic_model()
    n_chains, steps, burnin = 32, 600, 300
    runner = mc.SerialMC(steps=steps, burnin=burnin)
    out = []

    essps = {}
    for name, sampler, grad_key in (
        ("NUTS(md=6)", mc.NUTS(maxdoublings=6), "ndoublings"),
        ("ChEES", mc.ChEESHMC(len0=0.2), "nleaps"),
    ):
        infos, _, _ = run_chains(model, sampler, runner, n_chains, seed=0,
                                 jitter=0.2)
        jax.block_until_ready(infos["plogtarget"])
        t0 = time.perf_counter()
        infos, _, _ = run_chains(model, sampler, runner, n_chains, seed=1,
                                 jitter=0.2)
        x = np.asarray(infos["ppars"])[burnin:]
        dt = time.perf_counter() - t0

        if grad_key == "ndoublings":
            grads = float(np.sum(2.0 ** np.asarray(infos[grad_key])))
        else:
            grads = float(np.sum(np.asarray(infos[grad_key])))
        ess = _min_ess_pooled(x)
        essps[name] = ess / dt
        out += [
            (f"logistic 10x1000 {name}: transitions/s",
             n_chains * steps / dt, "steps/s"),
            (f"logistic 10x1000 {name}: pooled min-coord ESS/s",
             ess / dt, "ESS/s"),
            (f"logistic 10x1000 {name}: min-coord ESS per 1k gradients",
             1000.0 * ess / grads, "ESS/kgrad"),
        ]

    return out
