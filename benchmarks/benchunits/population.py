"""Population-runner throughput: replica-exchange tempering (PTMC) and
adaptive annealed SMC (ASMC) on the logistic-regression posterior.

The reference has no tempering/SMC benchmarks (SerialTempMC/SeqMC are
untimed); these rates are the batched interacting-ensemble operating
points: rung-transitions/s for a fully-batched ladder and particle-moves/s
for annealed SMC (plus its adaptive stage count and logZ as sanity values).
"""
import time

import numpy as np


def run():
    import jax
    import jax.numpy as jnp

    import mcmc_jl as mc

    n, nbeta = 1000, 10
    rng = np.random.default_rng(1)
    Xh = np.column_stack([np.ones(n), rng.standard_normal((n, nbeta - 1))])
    beta0 = rng.standard_normal(nbeta)
    Yh = (rng.random(n) < 1.0 / (1.0 + np.exp(-Xh @ beta0))).astype(np.float64)
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    X, Y = jnp.asarray(Xh, dtype=dtype), jnp.asarray(Yh, dtype=dtype)
    L2PI = float(np.log(2 * np.pi))

    def logprior(th):
        return -0.5 * jnp.dot(th, th) - nbeta / 2 * L2PI

    def logp(th):
        logits = X @ th
        return (jnp.dot(Y, logits) - jnp.sum(jnp.logaddexp(0.0, logits))
                + logprior(th))

    model = mc.model(logp, gradient=True, init=jnp.zeros(nbeta, dtype=dtype),
                     check_init=False)
    out = []

    # --- PTMC: K rungs x W walkers, all advanced as one batch ------------
    K, W, steps = 8, 32, 400
    betas = tuple(float(((k + 1) / K) ** 2) for k in range(K))
    runner = mc.PTMC(steps=steps, swap_period=5, betas=betas, walkers=W)

    def ptmc_once(seed):
        chains = mc.run(model * mc.HMC(5, 0.1) * runner, seed=seed)
        return chains[0].diagnostics["logtarget"][-1]

    ptmc_once(0)  # compile
    ts = []
    for r in range(3):
        t0 = time.perf_counter()
        ptmc_once(r + 1)
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    out.append((f"logistic 10x1000: PTMC rung-transitions/s ({W}x{K} batch)",
                W * K * steps / dt, "transitions/s"))

    # --- ASMC: adaptive annealing with HMC rejuvenation ------------------
    N, moves = 2048, 2
    runner = mc.ASMC(particles=N, target_ess=0.5, moves=moves,
                     logprior=logprior,
                     prior_sample=lambda k: jax.random.normal(k, (nbeta,)))

    def asmc_once(seed):
        return mc.run(model * mc.HMC(5, 0.1) * runner, seed=seed)

    c = asmc_once(0)  # compile
    n_stages = c.diagnostics["n_stages"]
    ts = []
    for r in range(3):
        t0 = time.perf_counter()
        c = asmc_once(r + 1)
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    stages = c.diagnostics["n_stages"]
    out.append((f"logistic 10x1000: ASMC particle-moves/s ({N} particles, "
                f"{stages} adaptive stages)",
                N * moves * stages / dt, "moves/s"))
    out.append(("logistic 10x1000: ASMC logZ", float(c.diagnostics["logz"]),
                "nats"))
    return out
