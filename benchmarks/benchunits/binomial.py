"""Logistic-regression benchmark unit (reference: benchunits/binomial.jl).

Times: loglik eval, loglik+gradient eval, and RWM/HMC sampling throughput on
the 10-param x 1000-obs logistic model — the reference's "binomial 10x1000"
rows in benchlog.csv — plus the batched-chain variants that are the
engine's real operating point.
"""
import time

import numpy as np


def _timeit(f, inner=10, repeats=5):
    f()  # warm-up/compile
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(inner):
            r = f()
        _block(r)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


def _block(x):
    # a reduced fetch: fetching unreduced arrays would time the transfer
    import jax
    import jax.numpy as jnp

    for leaf in jax.tree_util.tree_leaves(x):
        if hasattr(leaf, "dtype"):  # host objects are already materialized
            float(jnp.sum(leaf))


def run():
    import jax
    import jax.numpy as jnp

    import mcmc_jl as mc
    from mcmc_jl.parallel import run_chains

    n, nbeta = 1000, 10
    rng = np.random.default_rng(1)
    Xh = np.column_stack([np.ones(n), rng.standard_normal((n, nbeta - 1))])
    beta0 = rng.standard_normal(nbeta)
    Yh = (rng.random(n) < 1.0 / (1.0 + np.exp(-Xh @ beta0))).astype(np.float64)
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    X, Y = jnp.asarray(Xh, dtype=dtype), jnp.asarray(Yh, dtype=dtype)

    def logp(theta):
        logits = X @ theta
        return (jnp.dot(Y, logits) - jnp.sum(jnp.logaddexp(0.0, logits))
                - 0.5 * jnp.dot(theta, theta))

    model = mc.model(logp, gradient=True, init=jnp.zeros(nbeta, dtype=dtype),
                     check_init=False)
    theta = model.init

    out = []
    t = _timeit(lambda: model.eval(theta))
    out.append(("binomial 10x1000: loglik eval", t * 1e3, "ms"))
    t = _timeit(lambda: model.evalallg(theta))
    out.append(("binomial 10x1000: loglik+gradient eval", t * 1e3, "ms"))

    # 100 RWM steps, single chain (the reference's unit, binomial.jl:25)
    runner = mc.SerialMC(steps=100)
    t = _timeit(
        lambda: run_chains(model, mc.RWM(0.05), runner, 1, seed=0)[0]["plogtarget"],
        inner=1, repeats=3,
    )
    out.append(("binomial 10x1000: 100 RWM steps (1 chain)", t * 1e3, "ms"))

    # batched-chain throughput (the engine's operating point)
    n_chains = 512
    t = _timeit(
        lambda: run_chains(model, mc.RWM(0.05), runner, n_chains,
                           seed=0)[0]["plogtarget"],
        inner=1, repeats=3,
    )
    out.append((f"binomial 10x1000: RWM steps/s ({n_chains} chains)",
                100 * n_chains / t, "steps/s"))
    t = _timeit(
        lambda: run_chains(model, mc.HMC(10, 0.05), runner, n_chains,
                           seed=0)[0]["plogtarget"],
        inner=1, repeats=3,
    )
    out.append((f"binomial 10x1000: HMC leapfrog/s ({n_chains} chains)",
                100 * 10 * n_chains / t, "leapfrog/s"))

    # MALA on the generic engine
    t = _timeit(
        lambda: run_chains(model, mc.MALA(0.0025), runner, n_chains,
                           seed=0)[0]["plogtarget"],
        inner=1, repeats=3,
    )
    out.append((f"binomial 10x1000: generic MALA trans/s ({n_chains} "
                f"chains)", 100 * n_chains / t, "trans/s"))
    return out
