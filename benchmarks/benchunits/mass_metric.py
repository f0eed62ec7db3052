"""Mass-metric warmup benchmark: diagonal vs dense on a correlated target.

Measures the statistical win of the windowed dense metric
(samplers/massadapt.py) over the diagonal one on a rho=0.95 mixed-scale
Gaussian — the workload class where diagonal preconditioning saturates.
No reference equivalent (the reference has no mass adaptation).
"""
import time

import numpy as np


def run():
    import jax.numpy as jnp

    import mcmc_jl as mc

    scales = np.array([3.0, 1.0, 0.5, 2.0])
    d = len(scales)
    rho = 0.95
    sig = (np.full((d, d), rho) + (1 - rho) * np.eye(d)) * np.outer(scales, scales)
    prec = jnp.asarray(np.linalg.inv(sig))
    model = mc.model(lambda v: -0.5 * v @ prec @ v, gradient=True,
                     init=jnp.zeros(d), check_init=False)
    runner = mc.SerialMC(steps=6000, burnin=2000)

    out = []
    for label, sampler in [
        ("diag", mc.HMC(10, 0.25, mass_adapt=True)),
        ("dense", mc.HMC(10, 0.25, mass_adapt="dense")),
    ]:
        chain = mc.run(model * sampler * runner, seed=0)  # compile
        t0 = time.perf_counter()
        chain = mc.run(model * sampler * runner, seed=1)
        dt = time.perf_counter() - t0
        min_ess = float(min(mc.ess(chain)))
        out.append((f"corr-gauss HMC {label} mass: min-coord ESS", min_ess,
                    "samples"))
        out.append((f"corr-gauss HMC {label} mass: min-coord ESS/s",
                    min_ess / dt, "ESS/s"))

    return out
