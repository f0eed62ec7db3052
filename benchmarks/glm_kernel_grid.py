"""GPU GLM trajectory kernel against the generic engine's XLA trajectory.

For each (chains, observations) cell of a grid on the logistic posterior
(d = 10), times one ``HMC(10, eps)`` trajectory of every chain two ways:

- ``xla``: the generic engine's arithmetic, ``leapfrog`` over the vmapped
  ``model.evalallg`` of ``model(glm=...)``;
- ``kernel``: :func:`mcmc_jl.ops.pallas_glm.glm_trajectory`.

Momentum refresh and the Metropolis test cost the same on both routes, so
the ratio of these times is the ratio of the sampling phases.  Prints one
JSON line per measurement; median of ``--reps`` timed calls after a
warm-up.

Usage: python benchmarks/glm_kernel_grid.py [--reps 10]
"""
import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

GRID_CHAINS = (1024, 2048, 4096, 8192, 16384, 65536)
GRID_OBS = (1000, 10000, 100000)


def timed(fn, reps):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def cell(C, N, reps):
    import jax
    import jax.numpy as jnp

    import mcmc_jl as mc
    from bench import logistic_data
    from mcmc_jl.ops.pallas_glm import (glm_trajectory, pad_chains,
                                        pad_design, padded_dim)
    from mcmc_jl.samplers.integrators import leapfrog

    d, n_leaps = 10, 10
    # a stable step at this N: the posterior sd shrinks like 1/sqrt(N)
    eps = 0.05 * float(np.sqrt(1000.0 / N))
    X, Y = logistic_data(N, d)
    model = mc.model(glm=("logistic", X, Y))
    rng = np.random.default_rng(2)
    th = jnp.asarray(0.02 * rng.standard_normal((C, d)), jnp.float32)
    m = jnp.asarray(rng.standard_normal((C, d)), jnp.float32)
    _, g = jax.jit(jax.vmap(model.evalallg))(th)

    @jax.jit
    def xla(th, m, g):
        def one(th, m, g):
            return jax.lax.fori_loop(
                0, n_leaps,
                lambda _, c: leapfrog(model, c[0], c[3], c[2], eps),
                (th, jnp.float32(0), g, m))
        return jax.vmap(one)(th, m, g)

    rows = [{"route": "xla", "chains": C, "obs": N,
             "seconds": timed(lambda: xla(th, m, g), reps)}]
    XT, Yp, _, _ = pad_design(X, Y)
    args = [pad_chains(a, padded_dim(d)) for a in (th, m, g)]
    fn = jax.jit(lambda a, b, c: glm_trajectory(
        XT, Yp, None, None, a, b, c, n_obs=N, n_leaps=n_leaps, eps=eps))
    rows.append({"route": "kernel", "chains": C, "obs": N,
                 "seconds": timed(lambda: fn(*args), reps)})
    for r in rows:
        r["leapfrog_per_s"] = C * n_leaps / r["seconds"]
        print(json.dumps(r), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"glm_kernel_grid.py measures a GPU; JAX found "
                 f"{jax.devices()}")
    from mcmc_jl.utils.cache import enable_compile_cache

    enable_compile_cache()
    for N in GRID_OBS:
        for C in GRID_CHAINS:
            if C * N > 2_000_000_000:
                continue  # logits beyond 8 GB per product
            cell(C, N, args.reps)


if __name__ == "__main__":
    main()
